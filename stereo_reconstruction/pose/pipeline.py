"""Full sparse pose estimation: RANSAC 8-pt -> outlier filter -> LM BA.

Equivalent of the reference ``runFullPoseEstimation``
(``src/PoseEstimation/pose_estimation.cpp:4-115``), one jittable function
over a static match count:

  1. parallel-hypothesis RANSAC eight-point solve;
  2. re-triangulate *all* matches under the RANSAC pose and filter
     outliers by ``error > 2 * mean  OR  depth < 0``
     (pose_estimation.cpp:44-72);
  3. keep the first ``ba.num_points`` survivors — the reference truncates
     to exactly 60 because of Ceres template arity and throws when fewer
     survive (pose_estimation.cpp:77-89); here the set is padded with
     zero-weight slots instead of throwing, and ``enough_points`` reports
     the reference's would-be-throw condition;
  4. bundle-adjust pose + points; report both stages' mean reprojection
     errors (pose_estimation.cpp:99-101).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_reconstruction.config import PipelineConfig
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.pose import ba as ba_mod
from stereo_reconstruction.pose.ransac import ransac_eight_point


class PoseEstimate(NamedTuple):
    pose: jnp.ndarray             # (4, 4) BA-refined pose
    pose_ransac: jnp.ndarray      # (4, 4) 8pt/RANSAC pose
    fundamental: jnp.ndarray      # (3, 3) F from the BA pose
    keypoints_left: jnp.ndarray   # (3, M) the BA support set (padded)
    keypoints_right: jnp.ndarray  # (3, M)
    weights: jnp.ndarray          # (M,) 1 = real point, 0 = padding
    reproj_error_8pt: jnp.ndarray  # () mean reprojection error, 8pt stage
    reproj_error_ba: jnp.ndarray   # () mean reprojection error, after BA
    num_inliers: jnp.ndarray      # () filtered survivor count
    enough_points: jnp.ndarray    # () bool: >= ba.num_points survivors
    valid: jnp.ndarray            # () bool: RANSAC produced a valid pose


@functools.partial(jax.jit, static_argnames=("config",))
def estimate_pose_from_matches(
    key: jax.Array,
    matches_left: jnp.ndarray,    # (3, N) homogeneous pixel coords
    matches_right: jnp.ndarray,   # (3, N)
    K_left: jnp.ndarray,
    K_right: jnp.ndarray,
    config: PipelineConfig = PipelineConfig(),
    num_matches_valid=None,       # int or traced scalar (None -> all N)
) -> PoseEstimate:
    n = matches_left.shape[-1]
    n_valid = n if num_matches_valid is None else num_matches_valid
    m = config.ba.num_points

    rr = ransac_eight_point(
        key, matches_left, matches_right, K_left, K_right,
        config.ransac, num_matches_valid,
    )
    R, T = rr.rotation, rr.translation

    # triangulate all matches under the RANSAC pose (pose_estimation.cpp:44-53).
    # Padded/invalid columns are replaced by a copy of the first match: the
    # depth triangulation couples every column through one eigen-system
    # (eight_point.cpp:120-147), so garbage columns would corrupt all depths.
    in_range_cols = (jnp.arange(n) < n_valid)[None, :]
    safe_left = jnp.where(in_range_cols, matches_left, matches_left[:, :1])
    safe_right = jnp.where(in_range_cols, matches_right, matches_right[:, :1])
    xl = geo.normalize_points(K_left, safe_left)
    xr = geo.normalize_points(K_right, safe_right)
    depths = geo.triangulate_depths(xl, xr, R, T)
    pts_left = xl * depths[None, :]
    pts_right = geo.transform(R, T, pts_left)
    proj_right = geo.project(K_right, pts_right)
    errors = geo.pixel_error(proj_right, matches_right)

    in_range = jnp.arange(n) < n_valid
    # reference dedup: uniqueColumnsInMatrix (utils.cpp:50-95) runs before
    # the eight-point <8 throw (eight_point.cpp:176-184), so the throw
    # condition counts UNIQUE match columns — 8 valid-but-duplicated
    # matches still throw there. Count first-occurrence valid columns.
    col = jnp.concatenate([matches_left, matches_right], axis=0)   # (6, N)
    eq = jnp.all(col[:, :, None] == col[:, None, :], axis=0)       # (N, N)
    ii = jnp.arange(n)
    dup_of_earlier = jnp.any(
        eq & (ii[None, :] < ii[:, None]) & in_range[None, :], axis=1
    )
    n_unique = jnp.sum(in_range & ~dup_of_earlier)
    mean_err = jnp.sum(jnp.where(in_range, errors, 0.0)) / jnp.maximum(n_valid, 1)
    keep = in_range & (errors <= 2.0 * mean_err) & (depths >= 0)
    num_survivors = jnp.sum(keep)

    # first-M survivors in original order: stable sort on (not keep)
    order = jnp.argsort(jnp.logical_not(keep), stable=True)
    sel = order[:m]
    weights = keep[sel].astype(jnp.float32)

    kp_l = matches_left[:, sel]
    kp_r = matches_right[:, sel]
    pts0 = pts_left[:, sel]
    # padded slots get a benign dummy point in front of both cameras
    dummy = jnp.array([0.0, 0.0, 1.0])
    pts0 = jnp.where(weights[None, :] > 0, pts0, dummy[:, None])
    kp_l = jnp.where(weights[None, :] > 0, kp_l, geo.project(K_left, dummy[:, None]))
    kp_r = jnp.where(
        weights[None, :] > 0,
        kp_r,
        geo.project(K_right, geo.transform(R, T, dummy[:, None])),
    )

    result = ba_mod.bundle_adjust(
        kp_l, kp_r, K_left, K_right, R, T, pts0,
        weights=weights, config=config.ba,
    )

    err_8pt = _masked_reconstruction_error(
        kp_l, kp_r, K_left, K_right, R, T, pts0, weights
    )
    err_ba = _masked_reconstruction_error(
        kp_l, kp_r, K_left, K_right,
        result.rotation, result.translation, result.points, weights,
    )

    return PoseEstimate(
        pose=result.pose,
        pose_ransac=rr.pose,
        fundamental=result.fundamental,
        keypoints_left=kp_l,
        keypoints_right=kp_r,
        weights=weights,
        reproj_error_8pt=err_8pt,
        reproj_error_ba=err_ba,
        num_inliers=num_survivors,
        enough_points=num_survivors >= m,
        # failure detection (SURVEY §5): a pose whose reprojection errors
        # are non-finite (degenerate triangulation / diverged BA) is not a
        # valid estimate even when RANSAC found a cheirality-valid model;
        # fewer than 8 UNIQUE matches is the reference's throw condition
        # (uniqueColumnsInMatrix then eight_point.cpp:176-184) — here a
        # traced flag, not an abort
        valid=rr.valid & jnp.isfinite(err_8pt) & jnp.isfinite(err_ba)
        & (n_unique >= 8),
    )


def _masked_reconstruction_error(kp_l, kp_r, K_l, K_r, R, T, pts, w):
    """Weighted version of geo.average_reconstruction_error
    (reference utils.cpp:98-120)."""
    nw = jnp.maximum(jnp.sum(w), 1.0)
    proj_l = geo.project(K_l, pts)
    err_l = jnp.sum(jnp.linalg.norm(proj_l - kp_l, axis=-2) * w) / nw
    pts_r = geo.transform(R, T, pts)
    proj_r = geo.project(K_r, pts_r)
    err_r = jnp.sum(jnp.linalg.norm(proj_r - kp_r, axis=-2) * w) / nw
    return (err_l + err_r) / 2.0
