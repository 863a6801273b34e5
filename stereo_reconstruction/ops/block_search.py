"""High-level dense window-search disparity (the reference's BlockSearch).

``block_search_right`` / ``block_search_left`` reproduce the reference's
``BlockSearch::computeDisparityMapRight/Left`` (BlockSearch.cpp:24-179)
end-to-end on device: cost volume (ops/cost_volume.py) -> smoothness
argmin (ops/smoothing.py) -> sentinel/black-pixel fixups.

The variable-window mode selects per pixel among a bounded set of window
sizes by the reference's texture test (grow while ||max(0, win - mean)||
< threshold, BlockSearch.cpp:125-142) — the unbounded growth of the
reference is capped at the largest configured size (documented deviation;
the reference's default path runs with varBlock=false).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from stereo_reconstruction.config import MatcherConfig
from stereo_reconstruction.ops import cost_volume as cv
from stereo_reconstruction.ops import pallas_cost_volume as pcv
from stereo_reconstruction.ops import smoothing


@functools.partial(jax.jit, static_argnames=("config", "interpret"))
def block_search_right(
    left: jnp.ndarray,       # (H, W_l, 3) rectified left image (float32/uint8)
    right: jnp.ndarray,      # (H, W, 3) rectified right image
    config: MatcherConfig = MatcherConfig(),
    interpret: bool = False,  # run the fused kernel in the Pallas interpreter
) -> jnp.ndarray:
    """Disparity of the right image, (H, W) float32.

    ``pcv.use_kernel`` picks the backend: the fused GPU kernel emits the
    five smoothing-scan inputs without writing the cost volume; the plain
    path builds the volume with XLA and reduces it."""
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    h = min(left.shape[0], right.shape[0])

    if pcv.use_kernel(config, interpret):
        m0, a0, c_zero, diag_up, diag_lf = pcv.pallas_matcher_inputs(
            left, right, config.block_size,
            config.min_disparity, config.max_disparity, interpret=interpret,
        )
        disp = smoothing.smoothed_argmin_from_inputs(
            m0, a0, c_zero, diag_up, diag_lf,
            cv.black_pixel_mask(right),
            smooth_factor=config.smooth_factor,
            d_first=config.min_disparity,
            n_planes=config.max_disparity - config.min_disparity,
        )
        rows_valid = jnp.arange(disp.shape[0]) < h
        return jnp.where(rows_valid[:, None], disp, 0.0)

    if config.var_block:
        cost = _varblock_cost(left, right, config)
    elif config.cost == "ncc":
        cost = cv.cost_volume_right_ncc(
            left, right, config.block_size, config.min_disparity, config.max_disparity
        )
    elif config.cost == "sad":
        cost = cv.cost_volume_right_sad(
            left, right, config.block_size, config.min_disparity, config.max_disparity
        )
    else:
        cost = cv.cost_volume_right_ssd(
            left, right, config.block_size, config.min_disparity, config.max_disparity
        )

    black = cv.black_pixel_mask(right)
    if config.min_disparity >= 0:
        # O(W)-scan fast path, exact for the reference's sign-quirk mode
        disp = smoothing.smoothed_argmin_reference(
            cost,
            black,
            smooth_factor=config.smooth_factor,
            iters=config.row_smooth_iters,
            d_first=config.min_disparity,
        )
    else:
        dvals = jnp.arange(config.min_disparity, config.max_disparity)
        disp = smoothing.smoothed_argmin(
            cost,
            dvals,
            black,
            smooth_factor=config.smooth_factor,
            mode="reference",
            iters=None,   # in-row sweeps to fixpoint: exact (smoothing.py)
            variant="right",
        )
    # rows beyond min(h1, h2) are never visited by the reference
    rows_valid = jnp.arange(disp.shape[0]) < h
    return jnp.where(rows_valid[:, None], disp, 0.0)


@functools.partial(jax.jit, static_argnames=("config",))
def block_search_left(
    left: jnp.ndarray,
    right: jnp.ndarray,
    config: MatcherConfig = MatcherConfig(),
) -> jnp.ndarray:
    """Disparity of the left image, (H, W) float32 (BlockSearch.cpp:24-86)."""
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    h = min(left.shape[0], right.shape[0])

    cost = cv.cost_volume_left_ssd(
        left, right, config.block_size, config.max_disparity
    )
    dvals = jnp.arange(1, config.max_disparity + 1)
    black = cv.black_pixel_mask(left)
    disp = smoothing.smoothed_argmin(
        cost,
        dvals,
        black,
        smooth_factor=config.smooth_factor,
        mode="intended",   # the Left variant's discount has the correct sign
        iters=None,        # in-row sweeps to fixpoint: exact (smoothing.py)
        variant="left",
    )
    # border pixels (outside [hbs, H-hbs) x [hbs, W-hbs)) keep 0 in the
    # reference; cost planes are inf there so disp==sentinel x -> force 0
    hbs = (config.block_size - 1) // 2
    ys = jnp.arange(disp.shape[0])[:, None]
    xs = jnp.arange(disp.shape[1])[None, :]
    interior = (ys >= hbs) & (ys < h - hbs) & (xs >= hbs) & (xs < left.shape[1] - hbs)
    return jnp.where(interior, disp, 0.0)


def _varblock_cost(left, right, config: MatcherConfig) -> jnp.ndarray:
    """Cost volume with per-pixel window size selected by texture."""
    sizes = tuple(sorted(config.var_block_sizes))
    sel = _texture_select(right, sizes, config.texture_threshold)  # (H, W) int

    out = None
    for k, bs in enumerate(sizes):
        c = cv.cost_volume_right_ssd(
            left, right, bs, config.min_disparity, config.max_disparity
        )
        out = c if out is None else jnp.where((sel == k)[None, :, :], c, out)
    return out


def _texture_select(right, sizes: Tuple[int, ...], threshold: float) -> jnp.ndarray:
    """Per-pixel index of the first window size whose texture measure
    passes the threshold (falls back to the largest size)."""
    h, w = right.shape[:2]
    sel = jnp.full((h, w), len(sizes) - 1, jnp.int32)
    for k in reversed(range(len(sizes) - 1)):
        tex = window_texture(right, sizes[k])
        sel = jnp.where(tex >= threshold, k, sel)
    return sel


def window_texture(image: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Reference texture measure over the clipped window
    (BlockSearch.cpp:125-128): ||max(0, v - round(mean))||_2 per pixel,
    where the mean is the per-channel window mean (uint8 saturation of
    cv::subtract reproduced via the clamp at 0)."""
    image = image.astype(jnp.float32)
    hbs = (block_size - 1) // 2
    _, _, _, _, area = cv.right_window_geometry(image.shape[0], image.shape[1], block_size)
    n = jnp.maximum(area, 1.0)

    # per-channel window means
    sums = jnp.stack(
        [cv._clipped_window_sum(image[..., c], hbs) for c in range(image.shape[-1])],
        axis=-1,
    )
    mean = sums / n[..., None]

    # sum over window of clip(round(v - mean_window(center)), 0, 255)^2:
    # the subtraction uses the *center pixel's* window mean for every
    # element of its window, so this is a windowed sum of shifted images
    # evaluated per center -> implement by unrolled shifts over the window.
    h, w = image.shape[:2]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    up = jnp.minimum(ys, hbs)
    down = jnp.minimum(h - 1 - ys, hbs)
    lft = jnp.minimum(xs, hbs)
    rgt = jnp.minimum(w - 1 - xs, hbs)

    total = jnp.zeros((h, w), jnp.float32)
    for dy in range(-hbs, hbs):
        shifted_y = jnp.roll(image, -dy, axis=0)
        in_y = (dy >= -up) & (dy < down)
        for dx in range(-hbs, hbs):
            v = jnp.roll(shifted_y, -dx, axis=1)
            in_x = (dx >= -lft) & (dx < rgt)
            diff = jnp.clip(jnp.round(v - mean), 0.0, 255.0)
            contrib = jnp.sum(diff * diff, axis=-1)
            total = total + jnp.where(in_y & in_x, contrib, 0.0)
    return jnp.sqrt(total)
