"""Multi-scene quality gates over the recorded full-set evaluation
(baselines/full_eval.json, produced by tools/full_eval.py on all 15
MiddEval3 trainingQ scenes — VERDICT round-1 item 2).

Three contracts:
  * matcher parity: on identical rectified inputs the dense matcher must
    reproduce the reference-semantics oracle essentially bit-for-bit on
    EVERY scene (the 0.5pp bad-2.0 budget is met with ~0 margin used);
  * end-to-end quality on the scenes that ship real GT (Teddy, ArtL):
    within 0.5pp bad-2.0 of the reference pipeline's own output —
    currently ~15pp BETTER;
  * every scene runs end-to-end (pose validity or the failure-detection
    fallback, no exceptions recorded).
"""

import json
import os

import pytest

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "baselines",
                       "full_eval.json")
BUDGET_PP = 0.5   # BASELINE.json north-star tolerance


@pytest.fixture(scope="module")
def fixture():
    if not os.path.isfile(FIXTURE):
        pytest.skip("baselines/full_eval.json not generated")
    with open(FIXTURE) as f:
        data = json.load(f)
    from conftest import warn_if_stale_baseline

    warn_if_stale_baseline(data, "full_eval.json")
    data = {k: v for k, v in data.items() if not k.startswith("_")}
    if len(data) < 15:
        pytest.skip("full_eval fixture incomplete")
    return data


def test_live_crop_matcher_parity(middeval_root):
    """LIVE gate through the same tool code path that records
    full_eval.json: matcher vs the reference-semantics oracle on a Teddy
    crop, seconds on CPU. A matcher regression fails CI here without
    anyone regenerating the recorded artifacts (VERDICT r2 item 4)."""
    import sys

    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from full_eval import matcher_parity

    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair

    pair = downsample_pair(MiddEval3(middeval_root).load_training(13))
    L = np.asarray(pair.image_left, np.uint8)[100:180, 100:356]
    R = np.asarray(pair.image_right, np.uint8)[100:180, 100:356]
    rec = matcher_parity(L, R, max_disparity=48)
    assert rec["exact_agreement"] >= 0.9999, rec
    assert rec["bad2_vs_oracle"] <= 0.01, rec


def test_matcher_parity_all_scenes(fixture):
    for name, rec in fixture.items():
        mp = rec.get("matcher_parity")
        assert mp, f"{name}: no matcher-parity record"
        assert mp["exact_agreement"] >= 0.9999, (
            f"{name}: exact agreement {mp['exact_agreement']:.6f}"
        )


def test_shared_pose_parity_all_scenes(fixture):
    """Seed-free end-to-end gate on ALL scenes (VERDICT r4 #5): with ONE
    shared F feeding both pipelines, our rectify+match+back-warp chain
    must track the oracle pipeline within 2pp bad-2.0 per scene. The
    matcher itself is exact on identical inputs (gate above); the budget
    here covers only warp-implementation numerics (device band warp vs
    cv2, NN rounding at half-pixel boundaries) — Teddy measures 0.72pp."""
    missing = [n for n, r in fixture.items() if "shared_pose" not in r]
    assert not missing, f"scenes without shared_pose record: {missing}"
    for name, rec in fixture.items():
        sp = rec["shared_pose"]
        assert sp["bad2_vs_oracle_pipeline"] <= 2.0, (
            f"{name}: shared-pose bad-2.0 "
            f"{sp['bad2_vs_oracle_pipeline']:.3f}% vs oracle pipeline")
        assert sp["exact_agreement"] >= 0.85, (name, sp)


def test_gt_scenes_beat_reference_baseline(fixture):
    """Both pipelines are RANSAC-seed stochastic (ArtL spans 58.4..62.6
    over 4 seeds); the +-0.5pp budget therefore gates 3-seed MEDIANS
    against each other, falling back to the single recorded draw for
    artifacts that predate the multi-seed recording."""
    for name in ("Teddy", "ArtL"):
        rec = fixture[name]
        b = rec["baseline"]
        s = rec["ssd"]
        ref = b.get("bad2_gt_median",
                    (b.get("metrics_gt") or {}).get("bad_percent"))
        ours = s.get("bad2_gt_median",
                     (s.get("metrics_gt") or {}).get("bad_percent"))
        assert ours is not None, f"{name}: no GT metrics for the run"
        assert ours <= ref + BUDGET_PP, (
            f"{name}: median bad-2.0 {ours:.2f}% vs reference {ref:.2f}%"
        )


def test_all_scenes_ran_end_to_end(fixture):
    for name, rec in fixture.items():
        for cfg_name in ("ssd", "ncc"):
            entry = rec.get(cfg_name)
            assert entry and "error" not in entry, (
                f"{name}/{cfg_name}: pipeline failed: "
                f"{(entry or {}).get('error')}"
            )
