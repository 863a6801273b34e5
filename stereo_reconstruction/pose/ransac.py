"""Parallel-hypothesis RANSAC for the eight-point solve.

The reference RANSAC (``src/PoseEstimation/eight_point.cpp:253-361``) is a
sequential point-swap refinement: sample 12 points, repeatedly replace the
single worst point, blacklist points that break cheirality, accept when all
per-point errors drop below 4 px. That control flow is hostile to batched
accelerators.

Replacement with the same accept thresholds and support size:
draw K independent 12-point hypotheses, run the batched eight-point solve
on all of them at once (one vmapped SVD batch), score each
hypothesis by mean projected pixel error with cheirality masking, and pick
the best. With K=128 the sample diversity strictly dominates the
reference's <=100 sequential swaps in practice.

Acceptance semantics preserved:
  * a hypothesis is discarded if cheirality fails (reference throw ->
    validity mask);
  * "success" means all per-point errors < 4 px (error_threshold);
  * the returned hypothesis maximizes inliers (error < threshold over the
    *full* match set), tie-broken by mean sample error — a strictly
    stronger criterion than the reference's best-sample-error bookkeeping.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_reconstruction.config import RansacConfig
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.pose.eight_point import eight_point as _eight_point


def _sampson_sq(F, xl, xr):
    """Squared Sampson (first-order geometric) distance per match, px^2."""
    Fx = F @ xl
    Ftx = F.mT @ xr
    num = jnp.sum(xr * Fx, axis=-2) ** 2
    den = (
        Fx[..., 0, :] ** 2 + Fx[..., 1, :] ** 2
        + Ftx[..., 0, :] ** 2 + Ftx[..., 1, :] ** 2
    )
    return num / jnp.maximum(den, 1e-12)


class RansacResult(NamedTuple):
    rotation: jnp.ndarray       # (3, 3)
    translation: jnp.ndarray    # (3,)
    essential: jnp.ndarray      # (3, 3)
    pose: jnp.ndarray           # (4, 4)
    sample_indices: jnp.ndarray  # (sample_size,) winning sample
    inlier_count: jnp.ndarray   # () int
    mean_error: jnp.ndarray     # () mean px error over the winning sample
    success: jnp.ndarray        # () bool: all sample errors < threshold
    valid: jnp.ndarray          # () bool: at least one cheirality-valid hyp


@functools.partial(jax.jit, static_argnames=("config",))
def ransac_eight_point(
    key: jax.Array,
    matches_left: jnp.ndarray,    # (3, N) homogeneous pixels
    matches_right: jnp.ndarray,   # (3, N)
    K_left: jnp.ndarray,
    K_right: jnp.ndarray,
    config: RansacConfig = RansacConfig(),
    num_matches_valid=None,       # int or traced scalar (None -> all N)
) -> RansacResult:
    n = matches_left.shape[-1]
    n_valid = n if num_matches_valid is None else num_matches_valid
    k = config.num_hypotheses
    s = config.sample_size

    # K independent samples of `s` distinct indices in [0, n_valid):
    # uniform random ranks restricted to the valid prefix (traceable in
    # n_valid, unlike jax.random.permutation(n_valid))
    keys = jax.random.split(key, k)
    col_ok = jnp.arange(n) < n_valid

    def draw(subkey):
        u = jnp.where(col_ok, jax.random.uniform(subkey, (n,)), jnp.inf)
        return jnp.argsort(u)[:s]

    samples = jax.vmap(draw)(keys)                       # (K, s)

    sl = jnp.take(matches_left, samples, axis=1)         # (3, K, s)
    sl = jnp.moveaxis(sl, 1, 0)                          # (K, 3, s)
    sr = jnp.moveaxis(jnp.take(matches_right, samples, axis=1), 1, 0)

    results = _eight_point(sl, sr, K_left, K_right)      # batched over K

    # score 1: per-sample projected pixel error (reference eight_point.cpp:282-287)
    proj = geo.project(K_right, results.points_right)    # (K, 3, s)
    sample_err = geo.pixel_error(proj, sr)               # (K, s)
    mean_err = jnp.mean(sample_err, axis=-1)
    all_below = jnp.all(sample_err < config.error_threshold, axis=-1)

    # score 2: full-set inliers by per-point Sampson distance on F.
    # (The joint depth triangulation the reference uses for its *sample*
    # couples all points through one eigen-system — gross outliers in the
    # full set would corrupt every point's depth, so it cannot rank
    # hypotheses; Sampson scores each match independently.)
    in_range = jnp.arange(n) < n_valid

    def full_inliers(E):
        F = geo.fundamental_from_essential(E, K_left, K_right)
        d2 = _sampson_sq(F, matches_left, matches_right)
        return jnp.sum((d2 < config.error_threshold**2) & in_range)

    inliers = jax.vmap(full_inliers)(results.essential)
    inliers = jnp.where(results.valid, inliers, -1)

    # winner: most inliers; tie-break by lower mean sample error
    score = inliers.astype(jnp.float32) - 1e-6 * mean_err
    best = jnp.argmax(score)

    # local refinement, mirroring the reference's point-swap polish
    # (eight_point.cpp:294-359): re-solve on the current model's tightest
    # `refine_support` matches by Sampson distance; keep a refit only if
    # it is cheirality-valid and does not lose inliers.
    support = min(config.refine_support, n)
    init_sample = samples[best][: min(s, support)]
    if init_sample.shape[0] < support:
        init_sample = jnp.pad(init_sample, (0, support - init_sample.shape[0]))
    cur = dict(
        rotation=results.rotation[best],
        translation=results.translation[best],
        essential=results.essential[best],
        pose=results.pose[best],
        sample=init_sample,
        inliers=inliers[best],
        mean_error=mean_err[best],
        success=all_below[best] & results.valid[best],
    )
    for _ in range(config.refine_rounds):
        F_cur = geo.fundamental_from_essential(cur["essential"], K_left, K_right)
        d2 = _sampson_sq(F_cur, matches_left, matches_right)
        order = jnp.argsort(jnp.where(in_range, d2, jnp.inf))
        top = order[:support]
        refit = _eight_point(
            matches_left[:, top], matches_right[:, top], K_left, K_right
        )
        refit_inl = jnp.where(refit.valid, full_inliers(refit.essential), -1)
        use = refit_inl >= cur["inliers"]

        def pick(a, b):
            return jnp.where(use, a, b)

        proj_r = geo.project(K_right, refit.points_right)
        errs = geo.pixel_error(proj_r, matches_right[:, top])
        cur = dict(
            rotation=pick(refit.rotation, cur["rotation"]),
            translation=pick(refit.translation, cur["translation"]),
            essential=pick(refit.essential, cur["essential"]),
            pose=pick(refit.pose, cur["pose"]),
            sample=pick(top, cur["sample"]),
            inliers=pick(refit_inl, cur["inliers"]),
            mean_error=pick(jnp.mean(errs), cur["mean_error"]),
            success=pick(
                jnp.all(errs < config.error_threshold) & refit.valid,
                cur["success"],
            ),
        )

    return RansacResult(
        rotation=cur["rotation"],
        translation=cur["translation"],
        essential=cur["essential"],
        pose=cur["pose"],
        sample_indices=cur["sample"],
        inlier_count=cur["inliers"],
        mean_error=cur["mean_error"],
        success=cur["success"],
        valid=jnp.any(results.valid),
    )
