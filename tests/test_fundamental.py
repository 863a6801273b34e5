"""Uncalibrated F-matrix estimation tests (reference
rectification_main.cpp:114-155 capability)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.pose.fundamental import (
    eight_point_fundamental,
    ransac_fundamental,
    sampson_distance,
)


def _scene(rng, n=60, outlier_frac=0.0, w=640, h=480):
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    R = np.asarray(geo.angle_axis_to_rotation(jnp.asarray([0.04, -0.1, 0.02])))
    T = np.array([-1.0, 0.1, 0.2])
    T /= np.linalg.norm(T)
    F_gt = np.linalg.inv(K).T @ (np.asarray(geo.skew(jnp.asarray(T))) @ R) @ np.linalg.inv(K)
    F_gt /= np.linalg.norm(F_gt)

    depths = rng.uniform(4, 12, n)
    xl = np.concatenate([rng.uniform(-0.4, 0.4, (2, n)), np.ones((1, n))])
    pts = xl * depths
    pts_r = R @ pts + T[:, None]
    kp_l = K @ (pts / pts[2:3])
    kp_r = K @ (pts_r / pts_r[2:3])

    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        kp_r[:2, idx] += rng.uniform(20, 60, (2, n_out)) * rng.choice([-1, 1], (2, n_out))
    return kp_l.astype(np.float32), kp_r.astype(np.float32), F_gt


def test_eight_point_fundamental_epipolar(rng):
    kp_l, kp_r, F_gt = _scene(rng, n=30)
    F = np.asarray(eight_point_fundamental(jnp.asarray(kp_l), jnp.asarray(kp_r)))
    resid = np.einsum("in,ij,jn->n", kp_r, F, kp_l)
    assert np.abs(resid).max() < 1e-2
    # F determined up to sign
    err = min(np.linalg.norm(F - F_gt), np.linalg.norm(F + F_gt))
    assert err < 5e-3


def test_sampson_distance_zero_on_inliers(rng):
    kp_l, kp_r, F_gt = _scene(rng, n=20)
    d = np.asarray(
        sampson_distance(jnp.asarray(F_gt, jnp.float32), jnp.asarray(kp_l), jnp.asarray(kp_r))
    )
    assert d.max() < 1e-2


def test_ransac_fundamental_with_outliers(rng):
    kp_l, kp_r, F_gt = _scene(rng, n=80, outlier_frac=0.25)
    res = ransac_fundamental(
        jax.random.key(0), jnp.asarray(kp_l), jnp.asarray(kp_r), num_hypotheses=64
    )
    assert bool(res.valid)
    assert int(res.num_inliers) >= 50
    F = np.asarray(res.F)
    err = min(np.linalg.norm(F - F_gt), np.linalg.norm(F + F_gt))
    assert err < 2e-2
    # outliers excluded from the mask
    mask = np.asarray(res.inlier_mask)
    d_gt = np.asarray(
        sampson_distance(jnp.asarray(F_gt, jnp.float32), jnp.asarray(kp_l), jnp.asarray(kp_r))
    )
    assert (d_gt[mask] < 4.0).mean() > 0.95
