"""Core projective-geometry primitives (jnp, fully vmappable).

Equivalents of the reference's math substrate
(``src/utils.cpp``): skew matrices, Kronecker products, projections,
reprojection errors. Everything here is shape-static and batched-friendly;
points are stored as (..., 3, N) homogeneous column matrices to mirror the
reference's Eigen ``Matrix3Xf`` layout.
"""

from __future__ import annotations

import jax.numpy as jnp


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric cross-product matrix (reference utils.cpp:23-34).

    Supports batched inputs: v (..., 3) -> (..., 3, 3).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def kron_vec(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Kronecker product of two vectors (reference utils.cpp:37-47):
    out[i*m + j] = a[i] * b[j]. Batched over leading dims."""
    return (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], -1)


def to_homogeneous(points: jnp.ndarray) -> jnp.ndarray:
    """(..., 2, N) pixel coords -> (..., 3, N) homogeneous."""
    ones = jnp.ones_like(points[..., :1, :])
    return jnp.concatenate([points, ones], axis=-2)


def from_homogeneous(points: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, N) -> (..., 2, N), dividing by the last row."""
    return points[..., :2, :] / points[..., 2:3, :]


def normalize_points(K: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply inverse intrinsics: K^{-1} @ points (reference
    eight_point.cpp:149-154). K (..., 3, 3), points (..., 3, N).

    Assumes K is an upper-triangular calibration matrix (standard pinhole
    intrinsics); exact back-substitution is both faster and more precise in
    f32 than a general solve.
    """
    p0, p1, p2 = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    k00 = K[..., 0, 0, None]
    k01 = K[..., 0, 1, None]
    k02 = K[..., 0, 2, None]
    k11 = K[..., 1, 1, None]
    k12 = K[..., 1, 2, None]
    k22 = K[..., 2, 2, None]
    u2 = p2 / k22
    u1 = (p1 - k12 * u2) / k11
    u0 = (p0 - k01 * u1 - k02 * u2) / k00
    return jnp.stack([u0, u1, u2], axis=-2)


def project(K: jnp.ndarray, points3d: jnp.ndarray) -> jnp.ndarray:
    """Pinhole projection to homogeneous pixels: (K @ X) / X_z.

    Matches reference ``averageReconstructionError``'s projection
    (utils.cpp:106): divides by the *camera-space* z row, so the returned
    third row is z/z = 1.
    """
    proj = K @ points3d
    return proj / points3d[..., 2:3, :]


def transform(R: jnp.ndarray, T: jnp.ndarray, points3d: jnp.ndarray) -> jnp.ndarray:
    """Rigid transform R @ X + T for (..., 3, N) points."""
    return R @ points3d + T[..., :, None]


def pixel_error(projected: jnp.ndarray, observed: jnp.ndarray) -> jnp.ndarray:
    """Per-point Euclidean pixel error over the first two rows
    (reference calculateEuclideanPixelError, eight_point.cpp:363-370)."""
    d = projected[..., :2, :] - observed[..., :2, :]
    return jnp.linalg.norm(d, axis=-2)


def average_reconstruction_error(
    matches_left: jnp.ndarray,
    matches_right: jnp.ndarray,
    K_left: jnp.ndarray,
    K_right: jnp.ndarray,
    rotation: jnp.ndarray,
    translation: jnp.ndarray,
    points_left_3d: jnp.ndarray,
) -> jnp.ndarray:
    """Two-view mean reprojection error (reference utils.cpp:98-120).

    Note the reference uses the *3-row* homogeneous difference norm (its
    projected third row is exactly 1 and the matches' third row is 1, so it
    equals the 2-row pixel norm).
    """
    proj_left = project(K_left, points_left_3d)
    err_left = jnp.linalg.norm(proj_left - matches_left, axis=-2).mean(axis=-1)

    points_right = transform(rotation, translation, points_left_3d)
    proj_right = project(K_right, points_right)
    err_right = jnp.linalg.norm(proj_right - matches_right, axis=-2).mean(axis=-1)

    return (err_left + err_right) / 2.0


def fundamental_from_essential(
    E: jnp.ndarray, K_left: jnp.ndarray, K_right: jnp.ndarray
) -> jnp.ndarray:
    """F = K_r^{-T} E K_l^{-1}, normalized to unit Frobenius norm
    (reference eight_point.cpp:205-208)."""
    F = jnp.linalg.inv(K_right).mT @ E @ jnp.linalg.inv(K_left)
    return F / jnp.linalg.norm(F)


def essential_from_pose(R: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """E = [T]_x R (reference eight_point.cpp:93)."""
    return skew(T) @ R


def angle_axis_to_rotation(aa: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: (..., 3) angle-axis -> (..., 3, 3) rotation.

    Replaces ceres::AngleAxisRotatePoint (reference
    bundle_adjustment.h:83). Safe at theta -> 0 via the quadrant-stable
    series form.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    K = skew(aa / jnp.maximum(theta[..., 0], 1e-12))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    sin, cos = jnp.sin(theta), jnp.cos(theta)
    R = eye + sin * K + (1.0 - cos) * (K @ K)
    # series fallback for tiny angles: R ~ I + skew(aa)
    small = theta2 < 1e-12
    return jnp.where(small, eye + skew(aa), R)


def rotation_to_angle_axis(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation -> (..., 3) angle-axis (reference
    rotToAngleAxis, bundle_adjustment.h:32-35)."""
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    axis_raw = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)
    scale = jnp.where(
        jnp.abs(sin_theta) > 1e-6, theta / (2.0 * jnp.maximum(jnp.abs(sin_theta), 1e-12)), 0.5
    )
    return axis_raw * scale[..., None]


def triangulate_depths(
    points_left_norm: jnp.ndarray,   # (..., 3, N) K^-1-normalized left points
    points_right_norm: jnp.ndarray,  # (..., 3, N)
    R: jnp.ndarray,                  # (..., 3, 3)
    T: jnp.ndarray,                  # (..., 3)
) -> jnp.ndarray:
    """Joint depth estimation for all N matches (reference
    ``estimateDepth``, eight_point.cpp:120-147).

    The reference builds M (3N x (N+1)) with M[3i:3i+3, i] = [x_r]_x R x_l
    and M[3i:3i+3, N] = [x_r]_x T and takes the eigenvector of M^T M with
    the smallest eigenvalue, rescaled so the translation coefficient is 1.
    M^T M is an ARROW matrix (diagonal + one border row/column), so that
    eigenvector comes from a 1-D secular-equation solve
    (ops/small_linalg.py arrow_smallest_eigvec) in O(N) per iteration —
    the dense (N+1)x(N+1) eigh this replaces dominated the batched pose
    stage at N=500 (VERDICT r4 #1) and serialized the K x 4-candidate
    RANSAC batch at N=8.

    Returns depths (..., N).
    """
    from stereo_reconstruction.ops.small_linalg import (
        arrow_smallest_eigvec,
    )

    # rows_i = skew(x_r_i) @ (R @ x_l_i)  -> (..., N, 3)
    Rxl = (R @ points_left_norm).mT                      # (..., N, 3)
    xr = points_right_norm.mT                             # (..., N, 3)
    skew_xr = skew(xr)                                    # (..., N, 3, 3)
    col_i = (skew_xr @ Rxl[..., :, None])[..., 0]         # (..., N, 3)
    col_T = (skew_xr @ jnp.broadcast_to(T[..., None, :, None], skew_xr.shape[:-2] + (3, 1)))[..., 0]

    # M^T M without materializing the sparse M:
    # MtM[i, j] for i,j < N is diag: col_i[i] . col_i[i] (block structure)
    # MtM[i, N] = col_i[i] . col_T[i];  MtM[N, N] = sum_i col_T[i].col_T[i]
    diag = jnp.sum(col_i * col_i, axis=-1)                # (..., N)
    cross = jnp.sum(col_i * col_T, axis=-1)               # (..., N)
    corner = jnp.sum(col_T * col_T, axis=-1).sum(axis=-1)  # (...,)

    _, depths = arrow_smallest_eigvec(diag, cross, corner)
    return depths
