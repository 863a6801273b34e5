"""Multi-view Schur-complement BA on a synthetic trajectory.

Model: the reference's synthetic BA fixture (test_bundle_adjustment.cpp:
9-67 — grid of points, known pose, noise, assert recovery) extended to an
M-camera trajectory (BASELINE config 5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_reconstruction.config import BundleAdjustmentConfig
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.parallel.ba_multiview import (
    distributed_multiview_bundle_adjust,
    fuse_point_cloud,
    multiview_bundle_adjust,
)
from stereo_reconstruction.parallel.mesh import make_mesh


def _synthetic_sequence(rng, M=4, n_grid=6):
    """M cameras on an arc observing a 3D grid; returns GT + noisy init."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    # points: grid at z ~ 8..12
    g = np.linspace(-2, 2, n_grid)
    xx, yy = np.meshgrid(g, g)
    zz = 10.0 + rng.uniform(-2, 2, xx.shape)
    X = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)  # (N, 3)
    N = X.shape[0]

    poses = np.zeros((M, 6))
    for m in range(1, M):
        ang = 0.08 * m
        poses[m, :3] = [0.0, ang, 0.02 * m]          # small rotation
        poses[m, 3:] = [0.5 * m, 0.05 * m, 0.1 * m]  # lateral motion

    obs = np.zeros((M, N, 2))
    for m in range(M):
        R = np.asarray(geo.angle_axis_to_rotation(jnp.asarray(poses[m, :3])))
        Xc = X @ R.T + poses[m, 3:]
        p = Xc @ K.T
        obs[m] = p[:, :2] / p[:, 2:3]
    return K, poses, X, obs


def _pose_errors(got, want):
    """(rotation deg, translation err) per camera after scale alignment."""
    scale = 1.0
    nw = np.linalg.norm(want[1:, 3:], axis=1)
    ng = np.linalg.norm(got[1:, 3:], axis=1)
    if ng.sum() > 0:
        scale = (nw * ng).sum() / max((ng * ng).sum(), 1e-12)
    rot_err, t_err = [], []
    for m in range(want.shape[0]):
        Rg = np.asarray(geo.angle_axis_to_rotation(jnp.asarray(got[m, :3])))
        Rw = np.asarray(geo.angle_axis_to_rotation(jnp.asarray(want[m, :3])))
        cosang = (np.trace(Rg.T @ Rw) - 1) / 2
        rot_err.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        t_err.append(np.linalg.norm(scale * got[m, 3:] - want[m, 3:]))
    return np.array(rot_err), np.array(t_err)


def test_multiview_ba_recovers_synthetic_trajectory(rng):
    K, poses_gt, X_gt, obs = _synthetic_sequence(rng, M=4)
    M, N = obs.shape[:2]

    # perturb: noisy points + noisy poses (cameras 1..M-1)
    X0 = X_gt + rng.normal(0, 0.1, X_gt.shape)
    poses0 = poses_gt.copy()
    poses0[1:, :3] += rng.normal(0, 0.01, (M - 1, 3))
    poses0[1:, 3:] += rng.normal(0, 0.05, (M - 1, 3))

    res = multiview_bundle_adjust(
        jnp.asarray(obs, jnp.float32),
        jnp.asarray(np.stack([K] * M), jnp.float32),
        jnp.asarray(poses0, jnp.float32),
        jnp.asarray(X0, jnp.float32),
        config=BundleAdjustmentConfig(loss="l2", max_iterations=25),
    )
    assert float(res.final_cost) < float(res.initial_cost) * 1e-3
    rot_err, t_err = _pose_errors(np.asarray(res.poses), poses_gt)
    assert rot_err.max() < 0.1, rot_err
    assert t_err.max() < 0.02, t_err
    # camera 0 is the gauge and must not move
    np.testing.assert_allclose(np.asarray(res.poses)[0], 0.0, atol=1e-7)


def test_multiview_ba_masked_observations(rng):
    """Points missing from some cameras (weight 0) are still recovered."""
    K, poses_gt, X_gt, obs = _synthetic_sequence(rng, M=3)
    M, N = obs.shape[:2]
    w = np.ones((M, N))
    w[1, : N // 4] = 0.0            # camera 1 misses a quarter of points
    obs = obs + rng.normal(0, 5000.0, obs.shape) * (1 - w[..., None])  # poison

    X0 = X_gt + rng.normal(0, 0.05, X_gt.shape)
    res = multiview_bundle_adjust(
        jnp.asarray(obs, jnp.float32),
        jnp.asarray(np.stack([K] * M), jnp.float32),
        jnp.asarray(poses_gt, jnp.float32),
        jnp.asarray(X0, jnp.float32),
        weights=jnp.asarray(w, jnp.float32),
        config=BundleAdjustmentConfig(loss="l2", max_iterations=20),
    )
    rot_err, t_err = _pose_errors(np.asarray(res.poses), poses_gt)
    assert rot_err.max() < 0.1
    assert t_err.max() < 0.02
    err = np.linalg.norm(np.asarray(res.points) - X_gt, axis=1)
    assert np.median(err) < 0.01


def test_distributed_multiview_matches_single_device(rng):
    """8-virtual-device sharded solve == single-device solve."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    K, poses_gt, X_gt, obs = _synthetic_sequence(rng, M=4, n_grid=8)
    M, N = obs.shape[:2]
    assert N % 8 == 0

    X0 = X_gt + rng.normal(0, 0.1, X_gt.shape)
    poses0 = poses_gt.copy()
    poses0[1:, 3:] += rng.normal(0, 0.05, (M - 1, 3))

    args = (
        jnp.asarray(obs, jnp.float32),
        jnp.asarray(np.stack([K] * M), jnp.float32),
        jnp.asarray(poses0, jnp.float32),
        jnp.asarray(X0, jnp.float32),
    )
    cfg = BundleAdjustmentConfig(loss="l2", max_iterations=15)
    single = multiview_bundle_adjust(*args, config=cfg)

    mesh = make_mesh(data=4, tile=2)
    dist = distributed_multiview_bundle_adjust(*args, mesh=mesh, config=cfg)

    # f32 psum order differs from the single-device sum -> slightly
    # different LM accept/reject path; both must land on the same optimum
    np.testing.assert_allclose(
        np.asarray(dist.poses), np.asarray(single.poses), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(dist.points), np.asarray(single.points), atol=5e-3
    )
    rot_err, t_err = _pose_errors(np.asarray(dist.poses), poses_gt)
    assert rot_err.max() < 0.1 and t_err.max() < 0.02

    fused = fuse_point_cloud(jnp.asarray(dist.points), mesh)
    np.testing.assert_allclose(
        np.asarray(fused), np.asarray(dist.points), rtol=1e-6
    )
