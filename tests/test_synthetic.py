"""Seeded synthetic scenes (data/synthetic.py): determinism, ground truth
that agrees with the rendered pixels, and the pipeline scored against it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction import oracle
from stereo_reconstruction.config import MatcherConfig, PipelineConfig
from stereo_reconstruction.data.synthetic import make_scene, pose_errors_deg
from stereo_reconstruction.ops.block_search import block_search_right
from stereo_reconstruction.pipeline import run_pair

H, W, D = 188, 225, 50


@pytest.fixture(scope="module")
def scene():
    return make_scene(1, H, W, D)


@pytest.fixture(scope="module")
def flat():
    return make_scene(0, H, W, D, rectified=True)


def test_same_seed_same_scene():
    a = make_scene(3, 40, 64, 16)
    b = make_scene(3, 40, 64, 16)
    for f in ("image_left", "image_right", "disp_right_gt", "mask_right_nocc"):
        np.testing.assert_array_equal(getattr(a.pair, f), getattr(b.pair, f))
    np.testing.assert_array_equal(a.rotation, b.rotation)
    c = make_scene(4, 40, 64, 16)
    assert not np.array_equal(a.pair.image_left, c.pair.image_left)


def test_scene_records(scene):
    p = scene.pair
    assert p.image_left.shape == (H, W, 3) and p.image_left.dtype == np.uint8
    assert p.image_left.min() >= 16          # never a black (skipped) pixel
    np.testing.assert_allclose(scene.rotation @ scene.rotation.T, np.eye(3),
                               atol=1e-12)
    assert scene.translation[0] < 0 and abs(scene.translation[1]) > 0
    assert set(np.unique(p.mask_right_nocc)) <= {0, 255}
    gt = p.disp_right_gt
    evaluated = p.mask_right_nocc == 255
    assert np.isfinite(gt[evaluated]).all()
    assert 0.5 < evaluated.mean() < 1.0      # occlusions are masked out
    assert (gt[evaluated] >= 0).all() and (gt[evaluated] < D).all()
    assert p.ndisp == D


def test_ground_truth_matches_pixels(flat):
    """On the rectified variant the true match of right pixel x is left
    pixel x + d on the same row: the colours agree there, and not at a
    disparity off by a few pixels."""
    p = flat.pair
    L = p.image_left.astype(np.float64)
    R = p.image_right.astype(np.float64)
    ys, xs = np.nonzero(p.mask_right_nocc == 255)
    d = np.rint(p.disp_right_gt[ys, xs]).astype(int)
    inside = xs + d + 3 < W
    ys, xs, d = ys[inside], xs[inside], d[inside]
    err_true = np.abs(L[ys, xs + d] - R[ys, xs]).mean()
    err_off = np.abs(L[ys, xs + d + 3] - R[ys, xs]).mean()
    assert err_true < 6.0 and err_off > 2 * err_true
    np.testing.assert_array_equal(flat.rotation, np.eye(3))


def test_matcher_on_synthetic_matches_oracle_and_truth(flat):
    p = flat.pair
    cfg = MatcherConfig(block_size=17, max_disparity=D, smooth_factor=0.9)
    band = slice(80, 112)
    L, R = p.image_left, p.image_right
    got = np.asarray(block_search_right(jnp.asarray(L[band]),
                                        jnp.asarray(R[band]), cfg))
    want = oracle.block_search_right_fast(L[band], R[band], 17, 0, D, 0.9)
    assert (got == want).mean() >= 0.99
    disp = np.asarray(block_search_right(jnp.asarray(L), jnp.asarray(R), cfg))
    ev = p.mask_right_nocc == 255
    bad2 = np.mean(np.abs(disp[ev] - p.disp_right_gt[ev]) > 2.0)
    assert bad2 < 0.15, bad2


def test_run_pair_on_synthetic_meets_truth_bounds(scene):
    """Pose, rectification and matching on an unrectified pair, scored
    against the scene: the bounds chip_smoke.py applies at full size."""
    import chip_smoke

    cfg = PipelineConfig()
    cfg = cfg.replace(matcher=dataclasses.replace(cfg.matcher, max_disparity=D))
    res = run_pair(scene.pair, cfg)
    assert res.metrics["pose_ok"] == 1.0
    rot, trans = pose_errors_deg(np.asarray(res.pose.pose), scene.rotation,
                                 scene.translation)
    assert rot <= chip_smoke.MAX_ROTATION_ERROR_DEG
    assert trans <= chip_smoke.MAX_TRANSLATION_ERROR_DEG
    assert res.metrics["bad_percent"] <= chip_smoke.MAX_BAD2_PERCENT


def test_pose_errors_deg():
    from stereo_reconstruction.data.synthetic import _rotation_x

    pose = np.eye(4)
    pose[:3, :3] = _rotation_x(np.deg2rad(2.0))
    pose[:3, 3] = [-1.0, 0.0, 0.0]
    rot, trans = pose_errors_deg(pose, np.eye(3), np.array([-2.0, 0.0, 0.0]))
    assert abs(rot - 2.0) < 1e-9 and trans < 1e-6
    pose[:3, 3] = [0.0, -1.0, 0.0]
    _, trans = pose_errors_deg(pose, np.eye(3), np.array([-1.0, 0.0, 0.0]))
    assert abs(trans - 90.0) < 1e-9
