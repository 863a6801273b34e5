"""Dense matching-cost volumes (XLA path).

Reformulation of the reference's ``BlockSearch`` hot loop
(``src/WindowSearch/BlockSearch.cpp:88-179``): instead of O(H*W*D*B^2)
scalar window loops, each disparity plane is a shifted per-pixel difference
image whose window sums come from two separable 1-D ``reduce_window``
passes — O(H*W*D*B) adds that XLA fuses. This is the plain path and the
reference for the fused GPU kernel (ops/pallas_cost_volume.py).

Exactness notes (validated against ``stereo_reconstruction.oracle``):

  * The reference Right-variant window spans ``[y-up, y+down) x
    [x-left, x+right)`` with ``up = min(y, hbs)``, ``down = min(H-1-y,
    hbs)`` etc. (BlockSearch.cpp:116-123). That is precisely the fixed
    half-open window ``[y-hbs, y+hbs) x [x-hbs, x+hbs)`` intersected with
    ``[0, H-1) x [0, W-1)`` — i.e. the *last row and column never
    participate*. We therefore zero the last row/col of the difference
    image and run a fixed ``(2*hbs, 2*hbs)`` zero-padded reduce_window,
    which reproduces the clipped sums bit-for-bit (integer diffs, exact in
    f32 up to ~2^24).
  * Candidate validity: ``x + d + right < W_left`` (the break at
    BlockSearch.cpp:148-149) and window area > 0; invalid costs are +inf.
  * Right-variant cost = sqrt(window SSD) / area (BlockSearch.cpp:158);
    Left-variant cost = sqrt(window SSD) over a full 17x17 window with
    border pixels skipped (BlockSearch.cpp:36-66).

Cost volume layout is ``(D, H, W)``: W is the minor (contiguous)
dimension and the argmin reduces over the leading axis.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def right_window_geometry(h: int, w: int, block_size: int):
    """Per-pixel clipped window extents and area for the Right variant."""
    hbs = (block_size - 1) // 2
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    up = jnp.minimum(ys, hbs)
    down = jnp.minimum(h - 1 - ys, hbs)
    left = jnp.minimum(xs, hbs)
    right = jnp.minimum(w - 1 - xs, hbs)
    area = ((left + right)[None, :] * (up + down)[:, None]).astype(jnp.float32)
    return left, right, up, down, area


def _centered_sliding_sum(plane: jnp.ndarray, size: int, before: int, axis: int):
    """out[i] = sum_{k=-before}^{size-1-before} plane[i+k], zeros outside.

    Lowered as a 1-D zero-padded reduce_window, the separable form that
    XLA compiles fast at D=200 scale.
    """
    lead = [(0, 0)] * plane.ndim
    window = [1] * plane.ndim
    window[axis] = size
    pad = [(0, 0)] * plane.ndim
    pad[axis] = (before, size - 1 - before)
    return lax.reduce_window(
        plane,
        jnp.array(0, plane.dtype),
        lax.add,
        window_dimensions=tuple(window),
        window_strides=(1,) * plane.ndim,
        padding=pad,
    )


def _clipped_window_sum(plane: jnp.ndarray, hbs: int,
                        row_valid: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Sum of ``plane`` over [y-hbs, y+hbs) x [x-hbs, x+hbs) clipped to
    [0, H-1) x [0, W-1), for every pixel. ``plane`` (..., H, W).

    ``row_valid`` overrides the default "all rows but the last" mask — the
    sharded matcher passes global-coordinate validity so that a row tile's
    edges are not mistaken for image borders (parallel/sharded.py).
    """
    h, w = plane.shape[-2:]
    # zero the last row/col: they are never inside a reference window
    mask_y = ((jnp.arange(h) < h - 1) if row_valid is None else row_valid)[:, None]
    mask_x = (jnp.arange(w) < w - 1)[None, :]
    masked = plane * (mask_y & mask_x)
    win = 2 * hbs
    if win <= 0:
        return jnp.zeros_like(plane)
    out = _centered_sliding_sum(masked, win, hbs, axis=plane.ndim - 2)
    return _centered_sliding_sum(out, win, hbs, axis=plane.ndim - 1)


def _full_window_sum(plane: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Sum over the full centered block_size x block_size window (Left
    variant), zero-padded (only interior pixels are consumed)."""
    hbs = (block_size - 1) // 2
    out = _centered_sliding_sum(plane, block_size, hbs, axis=plane.ndim - 2)
    return _centered_sliding_sum(out, block_size, hbs, axis=plane.ndim - 1)


@functools.partial(
    jax.jit, static_argnames=("block_size", "min_disparity", "max_disparity", "d_chunk")
)
def cost_volume_right_ssd(
    left: jnp.ndarray,    # (H, W_l, 3) float32
    right: jnp.ndarray,   # (H, W, 3) float32
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    d_chunk: int = 32,
    row_offset: Optional[jnp.ndarray] = None,   # global index of local row 0
    total_height: Optional[jnp.ndarray] = None,  # global image height
) -> jnp.ndarray:
    """Right-variant SSD cost volume, shape (D, H, W), +inf = invalid.

    ``row_offset``/``total_height`` make the window geometry use GLOBAL
    row coordinates: a halo-extended row tile of a larger image then
    produces bit-identical costs to the full-image computation for every
    in-bounds row (rows outside the image must hold zeros). Used by the
    sharded matcher (parallel/sharded.py).
    """
    h, w = right.shape[:2]
    w_l = left.shape[1]
    hbs = (block_size - 1) // 2
    D = max_disparity - min_disparity

    if row_offset is None:
        _, right_ext, _, _, area = right_window_geometry(h, w, block_size)
        row_valid = None
    else:
        h_tot = total_height if total_height is not None else h
        ys_g = row_offset + jnp.arange(h)
        xs_ = jnp.arange(w)
        up = jnp.clip(jnp.minimum(ys_g, hbs), 0)
        down = jnp.clip(jnp.minimum(h_tot - 1 - ys_g, hbs), 0)
        lft = jnp.minimum(xs_, hbs)
        rgt = jnp.minimum(w - 1 - xs_, hbs)
        in_img = (ys_g >= 0) & (ys_g < h_tot)
        area = ((lft + rgt)[None, :] * jnp.where(in_img, up + down, 0)[:, None]
                ).astype(jnp.float32)
        right_ext = rgt
        row_valid = (ys_g >= 0) & (ys_g < h_tot - 1)
    inv_area = jnp.where(area > 0, 1.0 / jnp.maximum(area, 1.0), jnp.inf)

    # pad left so L[:, x + d] is a static slice for every d
    pad_w = max(0, w + max_disparity - w_l)
    left_p = jnp.pad(left, ((0, 0), (0, pad_w), (0, 0)))

    xs = jnp.arange(w)

    def one_disparity(d):
        shifted = lax.dynamic_slice_in_dim(left_p, d, w, axis=1)
        diff = shifted - right
        dsq = jnp.sum(diff * diff, axis=-1)
        win = _clipped_window_sum(dsq, hbs, row_valid=row_valid)
        cost = jnp.sqrt(jnp.maximum(win, 0.0)) * inv_area
        valid = (xs[None, :] + d + right_ext[None, :]) < w_l
        return jnp.where(valid & (area > 0), cost, jnp.inf)

    def chunk(dc):
        return jax.vmap(one_disparity)(dc)

    dvals = jnp.arange(min_disparity, max_disparity)
    # chunked map over D bounds peak memory to d_chunk planes of temporaries
    d_chunk = max(1, min(d_chunk, D))
    n_pad = (-D) % d_chunk
    dvals_p = jnp.concatenate([dvals, jnp.full((n_pad,), max_disparity)])
    out = lax.map(chunk, dvals_p.reshape(-1, d_chunk))
    return out.reshape(-1, h, w)[:D]


@functools.partial(
    jax.jit, static_argnames=("block_size", "max_disparity", "d_chunk")
)
def cost_volume_left_ssd(
    left: jnp.ndarray,    # (H, W, 3) float32
    right: jnp.ndarray,   # (H, W_r, 3) float32
    block_size: int = 17,
    max_disparity: int = 200,
    d_chunk: int = 32,
) -> jnp.ndarray:
    """Left-variant SSD cost volume (BlockSearch.cpp:24-86).

    Disparity d = x - correspondX runs over [1, max_disparity]; returned
    plane index i corresponds to d = i + 1. Cost = sqrt(window SSD), full
    17x17 windows, valid only where both windows are fully interior.
    """
    h, w = left.shape[:2]
    w_r = right.shape[1]
    hbs = (block_size - 1) // 2
    D = max_disparity

    # pad the right image on the left by max_disparity so R[:, x-d] is the
    # slice right_p[:, max_disparity - d : ...], plus on the right to cover
    # x up to w when w_r < w
    right_p = jnp.pad(
        right, ((0, 0), (max_disparity, max(0, w - w_r)), (0, 0))
    )

    xs = jnp.arange(w)
    ys = jnp.arange(h)
    interior = (
        (ys[:, None] >= hbs)
        & (ys[:, None] < h - hbs)
        & (xs[None, :] >= hbs)
        & (xs[None, :] < w - hbs)
    )

    def one_disparity(d):
        shifted = lax.dynamic_slice_in_dim(right_p, max_disparity - d, w, axis=1)
        diff = left - shifted
        dsq = jnp.sum(diff * diff, axis=-1)
        win = _full_window_sum(dsq, block_size)
        cost = jnp.sqrt(jnp.maximum(win, 0.0))
        cx = xs[None, :] - d
        valid = interior & (cx >= hbs) & (cx < w_r - hbs)
        return jnp.where(valid, cost, jnp.inf)

    dvals = jnp.arange(1, max_disparity + 1)
    d_chunk = max(1, min(d_chunk, D))
    n_pad = (-D) % d_chunk
    dvals_p = jnp.concatenate([dvals, jnp.full((n_pad,), 1)])
    out = lax.map(lambda dc: jax.vmap(one_disparity)(dc), dvals_p.reshape(-1, d_chunk))
    return out.reshape(-1, h, w)[:D]


@functools.partial(
    jax.jit, static_argnames=("block_size", "min_disparity", "max_disparity", "d_chunk")
)
def cost_volume_right_sad(
    left: jnp.ndarray,    # (H, W_l, 3) float32
    right: jnp.ndarray,   # (H, W, 3) float32
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    d_chunk: int = 32,
) -> jnp.ndarray:
    """Right-variant SAD cost volume, shape (D, H, W), +inf = invalid.

    Framework extension (the reference matcher is SSD-only,
    BlockSearch.cpp:156-158): window sum of per-channel |diff|, normalized
    by window area like the Right SSD variant — more outlier-robust than
    SSD and one multiply cheaper per element.
    """
    h, w = right.shape[:2]
    w_l = left.shape[1]
    hbs = (block_size - 1) // 2

    _, right_ext, _, _, area = right_window_geometry(h, w, block_size)
    inv_area = jnp.where(area > 0, 1.0 / jnp.maximum(area, 1.0), jnp.inf)

    pad_w = max(0, w + max_disparity - w_l)
    left_p = jnp.pad(left, ((0, 0), (0, pad_w), (0, 0)))

    xs = jnp.arange(w)

    def one_disparity(d):
        shifted = lax.dynamic_slice_in_dim(left_p, d, w, axis=1)
        dabs = jnp.sum(jnp.abs(shifted - right), axis=-1)
        win = _clipped_window_sum(dabs, hbs)
        cost = win * inv_area
        valid = (xs[None, :] + d + right_ext[None, :]) < w_l
        return jnp.where(valid & (area > 0), cost, jnp.inf)

    D = max_disparity - min_disparity
    dvals = jnp.arange(min_disparity, max_disparity)
    d_chunk = max(1, min(d_chunk, D))
    n_pad = (-D) % d_chunk
    dvals_p = jnp.concatenate([dvals, jnp.full((n_pad,), max_disparity)])
    out = lax.map(lambda dc: jax.vmap(one_disparity)(dc), dvals_p.reshape(-1, d_chunk))
    return out.reshape(-1, h, w)[:D]


@functools.partial(
    jax.jit, static_argnames=("block_size", "min_disparity", "max_disparity", "d_chunk")
)
def cost_volume_right_ncc(
    left: jnp.ndarray,
    right: jnp.ndarray,
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    d_chunk: int = 32,
) -> jnp.ndarray:
    """Right-variant zero-normalized cross-correlation cost, (D, H, W).

    Framework extension (the reference matcher is SSD-only; NCC is the
    BASELINE config-2 cost). Cost = 1 - ZNCC over the same clipped windows
    on intensity (channel mean); range [0, 2], +inf = invalid.
    """
    h, w = right.shape[:2]
    w_l = left.shape[1]
    hbs = (block_size - 1) // 2
    D = max_disparity - min_disparity

    _, right_ext, _, _, area = right_window_geometry(h, w, block_size)
    n = jnp.maximum(area, 1.0)

    gl = jnp.mean(left, axis=-1)
    gr = jnp.mean(right, axis=-1)
    pad_w = max(0, w + max_disparity - w_l)
    gl_p = jnp.pad(gl, ((0, 0), (0, pad_w)))

    sum_r = _clipped_window_sum(gr, hbs)
    sum_r2 = _clipped_window_sum(gr * gr, hbs)
    var_r = jnp.maximum(sum_r2 - sum_r * sum_r / n, 0.0)

    xs = jnp.arange(w)

    def one_disparity(d):
        sl = lax.dynamic_slice_in_dim(gl_p, d, w, axis=1)
        sum_l = _clipped_window_sum(sl, hbs)
        sum_l2 = _clipped_window_sum(sl * sl, hbs)
        sum_lr = _clipped_window_sum(sl * gr, hbs)
        var_l = jnp.maximum(sum_l2 - sum_l * sum_l / n, 0.0)
        cov = sum_lr - sum_l * sum_r / n
        denom = jnp.sqrt(var_l * var_r)
        ncc = jnp.where(denom > 1e-6, cov / jnp.maximum(denom, 1e-6), 0.0)
        cost = 1.0 - ncc
        valid = ((xs[None, :] + d + right_ext[None, :]) < w_l) & (area > 0)
        return jnp.where(valid, cost, jnp.inf)

    dvals = jnp.arange(min_disparity, max_disparity)
    d_chunk = max(1, min(d_chunk, D))
    n_pad = (-D) % d_chunk
    dvals_p = jnp.concatenate([dvals, jnp.full((n_pad,), max_disparity)])
    out = lax.map(lambda dc: jax.vmap(one_disparity)(dc), dvals_p.reshape(-1, d_chunk))
    return out.reshape(-1, h, w)[:D]


def black_pixel_mask(image: jnp.ndarray) -> jnp.ndarray:
    """(H, W) bool: pixels that are exactly (0,0,0) — the reference's
    border-skip test (BlockSearch.cpp:105-108)."""
    return jnp.all(image == 0, axis=-1)
