"""Descriptor matching: one matmul + Lowe ratio + mutual check.

Replacement of the reference's FLANN kNN matcher
(``src/PoseEstimation/keypoints.cpp:12-24``): all pairwise distances come
from a single (K x K) Gram matmul — one large matrix product —
followed by a vectorized 2-NN ratio test (ratio 0.7, keypoints.h:19) and
an optional mutual-consistency check (framework addition; off matches the
reference).

Also includes the duplicate-position filter of
``transformMatchedKeypointsToEigen``/``uniqueColumnsInMatrix``
(utils.cpp:50-95): keep only the first match per (near-)identical left
keypoint position.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_reconstruction.config import FrontendConfig
from stereo_reconstruction.ops.features import Keypoints


class Matches(NamedTuple):
    left_xy: jnp.ndarray      # (M, 2) matched left keypoint positions
    right_xy: jnp.ndarray     # (M, 2)
    distance: jnp.ndarray     # (M,) best descriptor L2 distance
    valid: jnp.ndarray        # (M,) bool


@functools.partial(jax.jit, static_argnames=("config",))
def match_descriptors(
    kp_left: Keypoints,
    kp_right: Keypoints,
    config: FrontendConfig = FrontendConfig(),
) -> Matches:
    dl = kp_left.descriptors                     # (K, 128)
    dr = kp_right.descriptors
    K = dl.shape[0]

    # squared L2 distance matrix via one matmul
    gram = dl @ dr.T
    sq = (
        jnp.sum(dl * dl, axis=1)[:, None]
        + jnp.sum(dr * dr, axis=1)[None, :]
        - 2.0 * gram
    )
    sq = jnp.maximum(sq, 0.0)
    # invalid right keypoints must never be nearest neighbors
    sq = jnp.where(kp_right.valid[None, :], sq, jnp.inf)

    # 2-NN per left keypoint
    neg = -sq
    top2_val, top2_idx = jax.lax.top_k(neg, 2)
    d1 = jnp.sqrt(-top2_val[:, 0])
    d2 = jnp.sqrt(jnp.maximum(-top2_val[:, 1], 0.0))
    nn = top2_idx[:, 0]

    ratio_ok = d1 < config.ratio_threshold * d2
    valid = kp_left.valid & ratio_ok & jnp.isfinite(d1)

    if config.mutual_check:
        # the left index that is nearest to each right keypoint
        sq_l = jnp.where(kp_left.valid[:, None], sq, jnp.inf)
        back = jnp.argmin(sq_l, axis=0)           # (K,) right -> left
        valid = valid & (back[nn] == jnp.arange(K))

    left_xy = kp_left.xy
    right_xy = kp_right.xy[nn]

    valid = _filter_duplicate_positions(left_xy, valid)

    return Matches(
        left_xy=left_xy,
        right_xy=right_xy,
        distance=d1,
        valid=valid,
    )


@jax.jit
def match_descriptors_binary(
    kp_left: Keypoints,
    kp_right: Keypoints,
) -> Matches:
    """Brute-force Hamming matching with mutual cross-check — the
    semantics of the reference's ``cv::BFMatcher(NORM_HAMMING, true)``
    (``src/rectification_main.cpp:85``; plain nearest match, no ratio
    test).

    Descriptors are {0,1} float matrices (ops/binary_features.py), so
    Hamming(a, b) = |a| + |b| - 2 a.b: the full (K x K) distance matrix
    is one Gram matmul — brute force as a single matrix product.
    """
    dl = kp_left.descriptors                      # (K, bits) in {0,1}
    dr = kp_right.descriptors
    K = dl.shape[0]

    gram = dl @ dr.T
    ham = jnp.sum(dl, axis=1)[:, None] + jnp.sum(dr, axis=1)[None, :] - 2.0 * gram
    ham = jnp.where(kp_right.valid[None, :], ham, jnp.inf)

    nn = jnp.argmin(ham, axis=1)                  # left -> right
    d1 = jnp.take_along_axis(ham, nn[:, None], axis=1)[:, 0]

    # crossCheck=true: keep (i, j) only if i is also j's nearest left
    ham_l = jnp.where(kp_left.valid[:, None], ham, jnp.inf)
    back = jnp.argmin(ham_l, axis=0)              # right -> left
    valid = kp_left.valid & jnp.isfinite(d1) & (back[nn] == jnp.arange(K))

    left_xy = kp_left.xy
    right_xy = kp_right.xy[nn]
    valid = _filter_duplicate_positions(left_xy, valid)

    return Matches(left_xy=left_xy, right_xy=right_xy, distance=d1, valid=valid)


def _filter_duplicate_positions(xy: jnp.ndarray, valid: jnp.ndarray, tol: float = 1e-4):
    """Keep the first occurrence among (near-)duplicate positions
    (reference uniqueColumnsInMatrix, utils.cpp:77-95, tol 1e-4)."""
    d = jnp.linalg.norm(xy[:, None, :] - xy[None, :, :], axis=-1)   # (K, K)
    K = xy.shape[0]
    earlier = jnp.arange(K)[:, None] > jnp.arange(K)[None, :]        # j < i
    dup = jnp.any((d < tol) & earlier & valid[None, :], axis=1)
    return valid & jnp.logical_not(dup)


def matches_to_homogeneous(matches: Matches):
    """(3, M) homogeneous column matrices (reference
    transformMatchedKeypointsToEigen layout) + the validity mask."""
    ones = jnp.ones((matches.left_xy.shape[0], 1))
    left = jnp.concatenate([matches.left_xy, ones], axis=1).T
    right = jnp.concatenate([matches.right_xy, ones], axis=1).T
    return left, right, matches.valid
