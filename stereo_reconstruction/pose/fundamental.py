"""Uncalibrated fundamental-matrix estimation (normalized 8-point + RANSAC).

The reference's second frontend (``src/rectification_main.cpp:114-155``)
estimates F directly from matches with ``cv::findFundamentalMat(FM_8POINT |
FM_RANSAC, ransacReprojThreshold=1.0, confidence=0.99)`` — no intrinsics,
no essential decomposition. This module is that path, batched:

  * Hartley-normalized 8-point solve (isotropic scaling to mean distance
    sqrt(2) — the standard conditioning OpenCV applies);
  * rank-2 enforcement via SVD;
  * parallel-hypothesis RANSAC scored by Sampson distance with the same
    1 px threshold.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class FundamentalResult(NamedTuple):
    F: jnp.ndarray              # (3, 3), unit Frobenius norm
    inlier_mask: jnp.ndarray    # (N,) bool
    num_inliers: jnp.ndarray    # ()
    valid: jnp.ndarray          # ()


def _normalize_for_8pt(pts: jnp.ndarray):
    """Hartley normalization: translate to centroid, scale so the mean
    distance from origin is sqrt(2). pts (..., 3, N) homogeneous."""
    xy = pts[..., :2, :]
    centroid = jnp.mean(xy, axis=-1, keepdims=True)
    centered = xy - centroid
    mean_dist = jnp.mean(jnp.linalg.norm(centered, axis=-2), axis=-1)
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_dist, 1e-8)

    s = scale[..., None, None]
    T = jnp.zeros(pts.shape[:-2] + (3, 3), pts.dtype)
    T = T.at[..., 0, 0].set(scale)
    T = T.at[..., 1, 1].set(scale)
    T = T.at[..., 0, 2].set((-centroid[..., 0, 0]) * scale)
    T = T.at[..., 1, 2].set((-centroid[..., 1, 0]) * scale)
    T = T.at[..., 2, 2].set(1.0)
    return T @ pts, T


def eight_point_fundamental(
    matches_left: jnp.ndarray,    # (..., 3, N) homogeneous pixels
    matches_right: jnp.ndarray,
) -> jnp.ndarray:
    """Normalized 8-point F estimate, rank-2 enforced, unit norm.

    Constraint: x_r^T F x_l = 0.
    """
    xl, Tl = _normalize_for_8pt(matches_left)
    xr, Tr = _normalize_for_8pt(matches_right)

    # rows: kron(xl_i, xr_i) with F vectorized so that sum a_ab xl_a xr_b
    a = xl.mT[..., :, :, None] * xr.mT[..., :, None, :]   # (..., N, 3, 3)
    chi = a.reshape(*a.shape[:-2], 9)                      # (..., N, 9)
    _, _, vt = jnp.linalg.svd(chi, full_matrices=True)
    f_vec = vt[..., -1, :]
    # element (a, b) multiplies xl_a xr_b -> F_norm[b, a] = f[3a + b]
    Fn = f_vec.reshape(*f_vec.shape[:-1], 3, 3).mT

    # rank-2 projection
    U, S, Vt = jnp.linalg.svd(Fn)
    S2 = S.at[..., 2].set(0.0)
    Fn = U @ (S2[..., :, None] * Vt)

    # denormalize: x_r^T F x_l with x = T p  =>  F_p = Tr^T Fn Tl
    F = Tr.mT @ Fn @ Tl
    return F / jnp.maximum(jnp.linalg.norm(F, axis=(-2, -1), keepdims=True), 1e-12)


def sampson_distance(F: jnp.ndarray, xl: jnp.ndarray, xr: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) distance per match, in pixels.
    xl/xr (..., 3, N)."""
    Fx = F @ xl                      # (..., 3, N)
    Ftx = F.mT @ xr
    num = jnp.sum(xr * Fx, axis=-2) ** 2
    den = Fx[..., 0, :] ** 2 + Fx[..., 1, :] ** 2 + Ftx[..., 0, :] ** 2 + Ftx[..., 1, :] ** 2
    return num / jnp.maximum(den, 1e-12)


@functools.partial(
    jax.jit, static_argnames=("num_hypotheses", "num_matches_valid")
)
def ransac_fundamental(
    key: jax.Array,
    matches_left: jnp.ndarray,    # (3, N)
    matches_right: jnp.ndarray,
    threshold: float = 1.0,       # cv::findFundamentalMat default px
    num_hypotheses: int = 128,
    num_matches_valid: int | None = None,
) -> FundamentalResult:
    n = matches_left.shape[-1]
    n_valid = n if num_matches_valid is None else num_matches_valid

    keys = jax.random.split(key, num_hypotheses)
    samples = jax.vmap(lambda k: jax.random.permutation(k, n_valid)[:8])(keys)

    sl = jnp.moveaxis(jnp.take(matches_left, samples, axis=1), 1, 0)   # (K, 3, 8)
    sr = jnp.moveaxis(jnp.take(matches_right, samples, axis=1), 1, 0)
    Fs = eight_point_fundamental(sl, sr)                               # (K, 3, 3)

    d = jax.vmap(lambda F: sampson_distance(F, matches_left, matches_right))(Fs)
    in_range = jnp.arange(n) < n_valid
    inliers = jnp.sum((d < threshold**2) & in_range[None, :], axis=-1)
    best = jnp.argmax(inliers)

    # refit on the best hypothesis's tightest matches. A fixed-size subset
    # keeps shapes static; 32 smallest-distance matches are all inliers
    # whenever the model has >=32 (taking more risks pulling outliers into
    # the refit). Keep the refit only if it does not lose inliers.
    order = jnp.argsort(jnp.where(in_range, d[best], jnp.inf))
    top = order[: min(32, n)]
    F_refit = eight_point_fundamental(matches_left[:, top], matches_right[:, top])
    d_refit = sampson_distance(F_refit, matches_left, matches_right)
    refit_inliers = jnp.sum((d_refit < threshold**2) & in_range)

    use_refit = refit_inliers >= inliers[best]
    F = jnp.where(use_refit, F_refit, Fs[best])
    d_final = jnp.where(use_refit, d_refit, d[best])
    mask = (d_final < threshold**2) & in_range

    return FundamentalResult(
        F=F,
        inlier_mask=mask,
        num_inliers=jnp.sum(mask),
        valid=inliers[best] >= 8,
    )
