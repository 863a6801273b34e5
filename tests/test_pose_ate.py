"""Pose-trajectory (ATE) gate vs the reference pipeline (BASELINE north
star: "recovered pose trajectory within ATE tolerance of reference").

MiddEval3 pairs are rectified, so the TRUE two-view pose is known exactly:
R = I, T along (-1, 0, 0). The per-scene pose errors of this framework and
of the reference reproduction (tools/reference_baseline.py, literal-port
RANSAC + L2 BA) are recorded by tools/full_eval.py into
baselines/full_eval.json; this gate asserts (a) absolute accuracy on the
canonical evaluation scenes (/root/reference/src/main.cpp:19) and (b) that
the framework is within tolerance of — in fact better than — the
reference's own pose quality. A live Teddy pose check guards the fixture
against staleness.
"""

import json
import os

import numpy as np
import pytest

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "baselines",
                       "full_eval.json")
CANONICAL = ["Adirondack", "MotorcycleE", "Piano", "Shelves", "Teddy"]
T_TRUE = np.array([-1.0, 0.0, 0.0])


def _rot_err_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def _tdir_err_deg(T):
    c = abs(T @ T_TRUE) / (np.linalg.norm(T) + 1e-12)
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.fixture(scope="module")
def fixture():
    if not os.path.isfile(FIXTURE):
        pytest.skip("baselines/full_eval.json not generated")
    with open(FIXTURE) as f:
        return json.load(f)


def _errors(fixture):
    ours, ref = {}, {}
    for name, rec in fixture.items():
        b = (rec.get("baseline") or {}).get("pose")
        s = rec.get("ssd") or {}
        if not b or "pose" not in s:
            continue
        P = np.array(s["pose"])
        ours[name] = (_rot_err_deg(P[:3, :3]), _tdir_err_deg(P[:3, 3]))
        ref[name] = (_rot_err_deg(np.array(b["R"])),
                     _tdir_err_deg(np.array(b["T"])))
    return ours, ref


def test_pose_within_ate_tolerance_of_reference(fixture):
    ours, ref = _errors(fixture)
    assert len(ours) >= 10, "full_eval fixture incomplete"

    o = np.array(list(ours.values()))
    r = np.array(list(ref.values()))
    med_o, med_r = np.median(o, axis=0), np.median(r, axis=0)
    # within tolerance of the reference's own pose quality (and better)
    assert med_o[0] <= med_r[0] + 1.0, (med_o, med_r)
    assert med_o[1] <= med_r[1] + 2.0, (med_o, med_r)
    # absolute accuracy (the degenerate ArtL pose is flagged pose_ok=False
    # by failure detection and handled by the raw-pair fallback)
    assert med_o[0] < 1.0 and med_o[1] < 5.0


def test_pose_canonical_scenes(fixture):
    ours, _ = _errors(fixture)
    for name in CANONICAL:
        if name not in ours:
            continue
        rot, tdir = ours[name]
        assert rot < 5.0, f"{name}: rotation error {rot:.2f} deg"
        assert tdir < 30.0, f"{name}: translation direction {tdir:.2f} deg"


@pytest.mark.slow
def test_pose_live_teddy(middeval_root):
    """Live pose estimate on Teddy must match the known rectified pose."""
    from stereo_reconstruction.config import PipelineConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair
    from stereo_reconstruction.pipeline import estimate_pose

    pair = downsample_pair(MiddEval3(middeval_root).load_training(13))
    pose = estimate_pose(pair, PipelineConfig())
    assert bool(pose.valid)
    P = np.asarray(pose.pose)
    assert _rot_err_deg(P[:3, :3]) < 2.0
    assert _tdir_err_deg(P[:3, 3]) < 6.0
