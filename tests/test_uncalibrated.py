"""End-to-end uncalibrated pipeline (reference rectification_main.cpp):
ORB detect -> Hamming match -> F-RANSAC -> Loop-Zhang rectify -> linear
search -> F re-estimation + epiline artifacts.
"""

import os

import numpy as np
import pytest

from stereo_reconstruction.config import MatcherConfig, OrbConfig, PipelineConfig
from stereo_reconstruction.pipeline_uncalibrated import run_uncalibrated


def _pair(dx=6):
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (176, 240)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    return base[16:144, 16:200], base[16:144, 16 + dx : 200 + dx]


def test_uncalibrated_end_to_end(tmp_path):
    L, R = _pair()
    cfg = PipelineConfig(
        matcher=MatcherConfig(max_disparity=16),
        orb=OrbConfig(max_keypoints=256, num_levels=2),
    )
    out = str(tmp_path / "uncal")
    res = run_uncalibrated(L, R, cfg, output_dir=out)

    assert res.num_inliers >= 50
    assert res.F_rectified is not None
    # x'^T F x ~ 0 for a shifted pair: F maps shifted matches consistently
    assert np.isfinite(res.F).all()
    # artifacts written (rectification_main.cpp:204-214)
    for name in ("rectified_left.png", "rectified_right.png",
                 "disparity_linear.png"):
        assert os.path.exists(os.path.join(out, name))
    assert res.disparity.ndim == 2 and np.isfinite(res.disparity).all()
    # NB: a purely-shifted flat pair is a degenerate configuration for F
    # (any epipole on the x-axis fits), so no assertion on F's exact form —
    # the matched points satisfying x'^T F x = 0 is checked by RANSAC's
    # inlier count above.


def test_synthetic_pair_epipolar_alignment():
    """Rectified inlier matches must share scanlines (mean |dy| small) —
    the uncalibrated pipeline's core guarantee (VERDICT r2 item 7)."""
    L, R = _pair()
    cfg = PipelineConfig(
        matcher=MatcherConfig(max_disparity=16),
        orb=OrbConfig(max_keypoints=256, num_levels=2),
    )
    res = run_uncalibrated(L, R, cfg)
    assert np.isfinite(res.epipolar_alignment_px)
    assert res.epipolar_alignment_px <= 1.0, res.epipolar_alignment_px


@pytest.mark.slow
def test_real_scene_epipolar_alignment(middeval_root):
    """LIVE quality gate on a real scene at reduced resolution: the
    ORB+F+Loop-Zhang chain must rectify true correspondences onto common
    scanlines within 2px (the recorded 3-scene record is
    baselines/uncalibrated_eval.json via tools/uncalibrated_eval.py)."""
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair

    pair = downsample_pair(downsample_pair(
        MiddEval3(middeval_root).load_training(13)))
    cfg = PipelineConfig(matcher=MatcherConfig(max_disparity=64))
    res = run_uncalibrated(
        np.asarray(pair.image_left, np.uint8),
        np.asarray(pair.image_right, np.uint8), cfg, detector="orb")
    assert res.num_inliers >= 30
    assert res.epipolar_alignment_px <= 2.0, res.epipolar_alignment_px


def test_recorded_uncalibrated_eval_gate():
    """Gate the recorded 3-scene uncalibrated quality record."""
    import json

    path = os.path.join(os.path.dirname(__file__), "..", "baselines",
                        "uncalibrated_eval.json")
    if not os.path.exists(path):
        pytest.skip("uncalibrated_eval.json not generated")
    with open(path) as f:
        data = json.load(f)
    from conftest import warn_if_stale_baseline

    warn_if_stale_baseline(data, "uncalibrated_eval.json")
    assert len(data["scenes"]) >= 3
    for scene, rec in data["scenes"].items():
        for det, r in rec.items():
            assert r["num_inliers"] >= 30, (scene, det, r)
            assert r["epipolar_alignment_px"] <= 2.0, (scene, det, r)
