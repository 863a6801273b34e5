"""Pose estimation tests.

The golden 12-point fixture (keypoints, intrinsics, expected pose and 3D
points) is lifted as *data* from the reference's unit test
(``src/Tests/test_keypoints.cpp:21-53``) — SURVEY.md §4 calls this fixture
out as the reference's closest thing to a unit test. NB the reference test
itself forgets to call ``run()`` before reading the pose; we actually run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import PipelineConfig, RansacConfig
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.pose import (
    bundle_adjust,
    eight_point,
    estimate_pose_from_matches,
    ransac_eight_point,
)

# ---- golden fixture (reference test_keypoints.cpp:23-34) -------------------
KP_LEFT = np.array(
    [
        [10.0, 92.0, 8.0, 92.0, 289.0, 354.0, 289.0, 353.0, 69.0, 294.0, 44.0, 336.0],
        [232.0, 230.0, 334.0, 333.0, 230.0, 278.0, 340.0, 332.0, 90.0, 149.0, 475.0, 433.0],
        [1.0] * 12,
    ],
    dtype=np.float32,
)
KP_RIGHT = np.array(
    [
        [123.0, 203.0, 123.0, 202.0, 397.0, 472.0, 398.0, 472.0, 182.0, 401.0, 148.0, 447.0],
        [239.0, 237.0, 338.0, 338.0, 236.0, 286.0, 348.0, 341.0, 99.0, 153.0, 471.0, 445.0],
        [1.0] * 12,
    ],
    dtype=np.float32,
)
K_LEFT = np.array(
    [[844.310547, 0, 243.413315], [0, 1202.508301, 281.529236], [0, 0, 1]], np.float32
)
K_RIGHT = np.array(
    [[852.721008, 0, 252.021805], [0, 1215.657349, 288.587189], [0, 0, 1]], np.float32
)
# expected results (test_keypoints.cpp:40-53)
REF_ROTATION = np.array(
    [[0.9911, -0.0032, 0.1333], [0.0032, 1.0, 0.0], [-0.1333, 0.0004, 0.9911]]
)
REF_TRANSLATION = np.array([-0.4427, -0.0166, 0.8965])
REF_POINTS3D = np.array(
    [[-5.7313, -5.0535, -7.0558], [-0.8539, -1.2075, 1.1042], [20.7315, 28.1792, 25.3056]]
)


def test_eight_point_golden_fixture():
    res = eight_point(
        jnp.asarray(KP_LEFT), jnp.asarray(KP_RIGHT), jnp.asarray(K_LEFT), jnp.asarray(K_RIGHT)
    )
    assert bool(res.valid)
    # the fixture values embed the reference's own solver noise on this
    # 12-point real-data problem (f64 reproduces the same ~2e-3 offset);
    # the epipolar-constraint test below is the exact correctness gate
    np.testing.assert_allclose(np.asarray(res.rotation), REF_ROTATION, atol=5e-3)
    np.testing.assert_allclose(np.asarray(res.translation), REF_TRANSLATION, atol=5e-3)
    np.testing.assert_allclose(
        np.asarray(res.points_left[:, :3]), REF_POINTS3D, rtol=6e-2
    )
    # unit-norm translation comes from the essential-space projection
    # (f32 SVD on this noisy fixture leaves ~2e-3 residual)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(res.translation)), 1.0, atol=5e-3)


def test_eight_point_epipolar_constraint():
    res = eight_point(
        jnp.asarray(KP_LEFT), jnp.asarray(KP_RIGHT), jnp.asarray(K_LEFT), jnp.asarray(K_RIGHT)
    )
    F = geo.fundamental_from_essential(
        res.essential, jnp.asarray(K_LEFT), jnp.asarray(K_RIGHT)
    )
    # x_r^T F x_l ~ 0 for all matches
    vals = np.asarray(jnp.einsum("in,ij,jn->n", jnp.asarray(KP_RIGHT), F, jnp.asarray(KP_LEFT)))
    assert np.abs(vals).max() < 0.5


def test_eight_point_batched_matches_single():
    batch_l = jnp.stack([jnp.asarray(KP_LEFT)] * 3)
    batch_r = jnp.stack([jnp.asarray(KP_RIGHT)] * 3)
    res_b = eight_point(batch_l, batch_r, jnp.asarray(K_LEFT), jnp.asarray(K_RIGHT))
    res_s = eight_point(
        jnp.asarray(KP_LEFT), jnp.asarray(KP_RIGHT), jnp.asarray(K_LEFT), jnp.asarray(K_RIGHT)
    )
    np.testing.assert_allclose(
        np.asarray(res_b.rotation[1]), np.asarray(res_s.rotation), atol=1e-5
    )


def _synthetic_scene(rng, n=40, outlier_frac=0.25):
    """Synthetic two-view scene with known pose + salt of gross outliers."""
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
    aa = np.array([0.03, -0.12, 0.05])
    R = np.asarray(geo.angle_axis_to_rotation(jnp.asarray(aa)))
    T = np.array([-0.8, 0.05, 0.4])
    T = T / np.linalg.norm(T)
    depths = rng.uniform(4, 12, n)
    xl = np.concatenate([rng.uniform(-0.4, 0.4, (2, n)), np.ones((1, n))])
    pts = xl * depths
    pts_r = R @ pts + T[:, None]
    kp_l = K @ (pts / pts[2:3])
    kp_r = K @ (pts_r / pts_r[2:3])
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    kp_r[:2, idx] += rng.uniform(30, 80, (2, n_out)) * rng.choice([-1, 1], (2, n_out))
    return kp_l.astype(np.float32), kp_r.astype(np.float32), K, R, T


def test_ransac_rejects_outliers(rng):
    kp_l, kp_r, K, R_gt, T_gt = _synthetic_scene(rng)
    res = ransac_eight_point(
        jax.random.key(0), jnp.asarray(kp_l), jnp.asarray(kp_r),
        jnp.asarray(K), jnp.asarray(K), RansacConfig(num_hypotheses=64),
    )
    assert bool(res.valid)
    np.testing.assert_allclose(np.asarray(res.rotation), R_gt, atol=5e-3)
    t = np.asarray(res.translation)
    np.testing.assert_allclose(t / np.linalg.norm(t), T_gt, atol=2e-2)
    assert int(res.inlier_count) >= 25


def test_bundle_adjustment_synthetic_grid(rng):
    """The reference BA test scene (test_bundle_adjustment.cpp:9-67):
    9 grid points, rotation 50 deg about z, translation (0,0,10), noisy
    initial 3D points; LM must drive the cost far below the initial."""
    K = jnp.eye(3)
    matches_left = jnp.array(
        [[0, 0, 0, 250, 250, 250, 500, 500, 500],
         [0, 250, 500, 0, 250, 500, 0, 250, 500],
         [1, 1, 1, 1, 1, 1, 1, 1, 1]], jnp.float32,
    )
    depth = jnp.array([10, 10, 10, 20, 20, 20, 30, 30, 30], jnp.float32)
    pts = matches_left * depth[None, :]
    angle = 50 * np.pi / 180
    R_gt = jnp.array(
        [[np.cos(angle), -np.sin(angle), 0],
         [np.sin(angle), np.cos(angle), 0],
         [0, 0, 1]], jnp.float32,
    )
    T_gt = jnp.array([0.0, 0.0, 10.0])
    pts_r = geo.transform(R_gt, T_gt, pts)
    matches_right = geo.project(K, pts_r)

    noise = jnp.asarray(rng.normal(0, 1.0, (3, 9)).astype(np.float32))
    res = bundle_adjust(
        matches_left, matches_right, K, K,
        init_rotation=R_gt,          # reference inits rotation at identity but
        init_translation=T_gt,       # converges from noisy points; we start at
        init_points=pts + noise,     # GT pose + noisy points like the cost check
    )
    # this scene's coordinates are huge (|X| up to 2e4 with K=I), so the f32
    # cost floor is nonzero; LM must cut the cost by >100x and keep the pose
    assert float(res.final_cost) < float(res.initial_cost) * 1e-2
    np.testing.assert_allclose(np.asarray(res.rotation), np.asarray(R_gt), atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.translation), np.asarray(T_gt), atol=5e-2)


def test_bundle_adjustment_recovers_pose_from_bad_init(rng):
    """Start from a perturbed pose; LM must recover it."""
    kp_l, kp_r, K, R_gt, T_gt = _synthetic_scene(rng, n=30, outlier_frac=0.0)
    pts = None
    Kj = jnp.asarray(K)
    xl = geo.normalize_points(Kj, jnp.asarray(kp_l))
    xr = geo.normalize_points(Kj, jnp.asarray(kp_r))
    depths = geo.triangulate_depths(xl, xr, jnp.asarray(R_gt), jnp.asarray(T_gt))
    pts = xl * depths[None, :]

    aa_gt = np.asarray(geo.rotation_to_angle_axis(jnp.asarray(R_gt)))
    R_init = geo.angle_axis_to_rotation(jnp.asarray(aa_gt + 0.05))
    res = bundle_adjust(
        jnp.asarray(kp_l), jnp.asarray(kp_r), Kj, Kj,
        init_rotation=R_init,
        init_translation=jnp.asarray(T_gt + 0.1),
        init_points=pts,
    )
    np.testing.assert_allclose(np.asarray(res.rotation), R_gt, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.translation), T_gt, atol=5e-3)
    assert float(res.final_cost) < 1e-2


def test_full_pose_pipeline(rng):
    kp_l, kp_r, K, R_gt, T_gt = _synthetic_scene(rng, n=120, outlier_frac=0.15)
    cfg = PipelineConfig()
    est = estimate_pose_from_matches(
        jax.random.key(1), jnp.asarray(kp_l), jnp.asarray(kp_r),
        jnp.asarray(K), jnp.asarray(K), cfg,
    )
    assert bool(est.valid)
    assert bool(est.enough_points)
    # the 60-point BA support may retain a few gross outliers (the
    # reference's err>2*mean filter has the same property), which bounds
    # the mean reprojection error away from zero on this 15%-outlier set
    assert float(est.reproj_error_ba) < 6.0
    np.testing.assert_allclose(np.asarray(est.pose[:3, :3]), R_gt, atol=2e-2)
    # F has unit norm
    np.testing.assert_allclose(np.linalg.norm(np.asarray(est.fundamental)), 1.0, atol=1e-5)
