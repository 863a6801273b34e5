"""Perceptual (LPIPS) cost volume + window search.

Re-design of the reference notebook's row-by-row window search
(``Perceptual_window_search.ipynb`` cells 6-10): instead of a VGG forward
per 17x17 window (H x W/10 forwards!), full-image feature maps are
computed ONCE per image and the cost volume is formed by shifted
normalized-feature differences per stage — mathematically the window
LPIPS up to window-cropping effects (SURVEY.md §3.5), at a tiny fraction
of the FLOPs.

Per stage s (stride 2^s): cost_s[d, y, x] = lins_s . (Fl_s[:, y, x+d/2^s]
- Fr_s[:, y, x])^2 box-averaged over the window footprint; stage volumes
are upsampled to pixel resolution and summed. Fractional feature-space
shifts use linear interpolation between the two neighboring integer
shifts.

The notebook's multiplicative smoothing (cell 8 ``weight_vector``:
weight(i) = (1 - exp(-|i - argmin_prev| / sigma)) + bias, applied for the
previous-row argmin and the previous-pixel argmin, bias 0.85 / sigma 25)
runs as the same row-scan + Jacobi in-row scheme as the SSD matcher.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import jax
import jax.numpy as jnp
from jax import lax

from stereo_reconstruction.config import PerceptualConfig
from stereo_reconstruction.perceptual.vgg import (
    STAGE_STRIDES,
    normalize_features,
    vgg16_features,
    vgg16_features_batched,
)


@functools.partial(jax.jit, static_argnames=("config",))
def lpips_cost_volume(
    params: Dict,
    left: jnp.ndarray,      # (H, W, 3) RGB
    right: jnp.ndarray,     # (H, W, 3)
    config: PerceptualConfig = PerceptualConfig(),
) -> jnp.ndarray:
    """(D, H, W) perceptual cost volume for right-image disparities."""
    h, w = right.shape[:2]
    D = config.max_disparity
    window = config.window_size

    feats_l = [normalize_features(f) for f in vgg16_features(params, left)]
    feats_r = [normalize_features(f) for f in vgg16_features(params, right)]
    lins = params.get("lins") or [
        jnp.full((f.shape[0],), 1.0 / f.shape[0]) for f in feats_l
    ]

    total = jnp.zeros((D, h, w), jnp.float32)
    for s, (fl, fr, lin) in enumerate(zip(feats_l, feats_r, lins)):
        stride = STAGE_STRIDES[s]
        c, hs, ws = fl.shape
        lin = jnp.asarray(lin)

        # per-integer-shift weighted squared diff at stage resolution
        max_shift = (D - 1) // stride + 2
        fl_pad = jnp.pad(fl, ((0, 0), (0, 0), (0, max_shift)))

        def shift_cost(k):
            shifted = lax.dynamic_slice_in_dim(fl_pad, k, ws, axis=2)
            d2 = (shifted - fr) ** 2
            cost = jnp.einsum("c,chw->hw", lin, d2)
            # box-average over the window footprint at this stage
            win_s = max(1, window // stride)
            if win_s > 1:
                pad = [(win_s // 2, win_s - 1 - win_s // 2)] * 2
                cost = lax.reduce_window(
                    cost, jnp.float32(0), lax.add,
                    (win_s, win_s), (1, 1), pad,
                ) / (win_s * win_s)
            return cost

        stage_cost = jax.vmap(shift_cost)(jnp.arange(max_shift))   # (S, hs, ws)

        # pixel-resolution disparities -> fractional stage shifts
        dvals = jnp.arange(D, dtype=jnp.float32) / stride
        k0 = jnp.floor(dvals).astype(jnp.int32)
        frac = dvals - k0
        c0 = stage_cost[jnp.clip(k0, 0, max_shift - 1)]
        c1 = stage_cost[jnp.clip(k0 + 1, 0, max_shift - 1)]
        vol_s = c0 * (1 - frac)[:, None, None] + c1 * frac[:, None, None]

        # spatial upsample to (H, W) by nearest (stage stride replication);
        # when H/W are not stride-multiples the VGG pools floor the stage
        # size, so edge-replicate the last row/col up to the full canvas
        if stride > 1:
            vol_s = jnp.repeat(jnp.repeat(vol_s, stride, axis=1), stride, axis=2)
        vol_s = vol_s[:, :h, :w]
        pad_h, pad_w = h - vol_s.shape[1], w - vol_s.shape[2]
        if pad_h > 0 or pad_w > 0:
            vol_s = jnp.pad(vol_s, ((0, 0), (0, pad_h), (0, pad_w)), mode="edge")
        total = total + vol_s

    # invalid candidates: x + d beyond the left image
    xs = jnp.arange(w)
    valid = (xs[None, None, :] + jnp.arange(D)[:, None, None]) < w
    return jnp.where(valid, total, jnp.inf)


@functools.partial(jax.jit, static_argnames=("config", "iters"))
def perceptual_smooth_argmin(
    cost: jnp.ndarray,           # (D, H, W)
    config: PerceptualConfig = PerceptualConfig(),
    iters: int = 2,
) -> jnp.ndarray:
    """Notebook smoothing (cells 8,10): multiplicative weights around the
    previous-row and previous-pixel argmins, then argmin. Row scan +
    Jacobi sweeps for the in-row term."""
    D, h, w = cost.shape
    dvals = jnp.arange(D, dtype=jnp.float32)
    bias = config.smoothing_bias
    sigma = config.smoothing_sigma

    def weights(prev_idx):
        """(W,) previous argmins -> (D, W) weights; NaN = no weighting."""
        delta = jnp.abs(dvals[:, None] - prev_idx[None, :])
        wgt = (1.0 - jnp.exp(-delta / sigma)) + bias
        return jnp.where(jnp.isnan(prev_idx)[None, :], 1.0, wgt)

    def resolve(cost_row, up_w, left_idx):
        c = cost_row * up_w * weights(left_idx)
        idx = jnp.argmin(c, axis=0)
        ok = jnp.isfinite(jnp.min(c, axis=0))
        return jnp.where(ok, idx.astype(jnp.float32), 0.0)

    def row_step(prev, inputs):
        cost_row, first = inputs
        up_w = jnp.where(first, 1.0, weights(prev))
        disp = resolve(cost_row, up_w, jnp.full((w,), jnp.nan))
        for _ in range(max(0, iters - 1)):
            left_idx = jnp.concatenate([jnp.array([jnp.nan]), disp[:-1]])
            disp = resolve(cost_row, up_w, left_idx)
        return disp, disp

    first_flags = jnp.zeros((h,), bool).at[0].set(True)
    _, disp = lax.scan(
        row_step, jnp.zeros((w,), jnp.float32),
        (jnp.moveaxis(cost, 1, 0), first_flags),
    )
    return disp


def perceptual_window_search(
    params: Dict,
    left: jnp.ndarray,
    right: jnp.ndarray,
    config: PerceptualConfig = PerceptualConfig(),
) -> jnp.ndarray:
    """Full perceptual disparity search (BASELINE config 3).

    ``config.mode`` selects the backend:
      * ``"windowed"`` (default) — per-window VGG embeddings, exactly the
        notebook's semantics, batched into wide matmuls (below);
      * ``"full_image"`` — the shared full-image feature approximation
        (lpips_cost_volume), ~10x fewer FLOPs but a structural
        approximation of the per-window receptive field.
    """
    if config.mode == "full_image":
        cost = lpips_cost_volume(params, left, right, config)
        return perceptual_smooth_argmin(cost, config)
    return windowed_lpips_search(params, left, right, config)


@functools.partial(jax.jit, static_argnames=("config",))
def windowed_lpips_cost_volume(
    params: Dict,
    left: jnp.ndarray,      # (H, W, 3) RGB [0, 255]
    right: jnp.ndarray,     # (H, W, 3)
    config: PerceptualConfig = PerceptualConfig(),
) -> jnp.ndarray:
    """(H, D, W) notebook-exact per-window LPIPS cost volume.

    Reproduces ``Perceptual_window_search.ipynb`` cells 6-8 semantics
    bit-for-bit up to f32 vs the notebook's f64 score arithmetic:

      * every pixel owns a zero-padded ``window x window`` crop (cell 6
        unfold, padding 8) forwarded through the VGG tower INDEPENDENTLY
        — boundary content inside each crop matches the notebook, unlike
        full-image features;
      * LPIPS distance per candidate (cell 8 ``compute_distance``):
        channel-unit-normalize, squared diff, ``lins`` weighting, spatial
        mean per stage, summed over stages — expanded here into
        norm/cross terms so the candidate band is D shifted row dots, not
        a W x W matrix.

    Device mapping (row-BLOCKED for matmul width): one lax.scan over
    blocks of ``config.row_block`` rows; per block the row_block*W crops
    of each image run as ONE batched conv stack
    (vgg16_features_batched — the per-window forwards the notebook does
    in chunks of 10 become wide conv batches), and the D candidate
    distances are banded row dots vmapped over the block's rows. The
    full volume is only D*H*W f32 (67 MB at trainingQ/D=100), far below
    HBM, and materializing it decouples the conv tower from the
    sequential smoothing scan.
    """
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    h, w = right.shape[:2]
    D = min(config.max_disparity, w)
    win, pad = config.window_size, config.padding
    R = max(1, min(config.row_block, h))
    n_blocks = -(-h // R)

    padded_l = jnp.pad(left, ((pad, pad), (pad, pad), (0, 0)))
    padded_r = jnp.pad(right, ((pad, pad), (pad, pad), (0, 0)))

    xs = jnp.arange(w)
    sizes = jnp.minimum(D, w - xs)                     # candidate counts
    dvals = jnp.arange(D, dtype=jnp.float32)
    valid = dvals[:, None] < sizes[None, :].astype(jnp.float32)   # (D, W)
    lins = params.get("lins") or [
        jnp.full((c,), 1.0 / c, jnp.float32)
        for c in (64, 128, 256, 512, 512)
    ]

    def block_windows(padded, y0):
        # rows y0..y0+R-1's windows; window (r, x) = padded[y0+r : y0+r+win,
        # x : x+win] (original top-left (y-pad, x-pad), like the oracle).
        # dynamic_slice clamps y0 at the image end; clamped rows belong to
        # the discarded tail of the last (padded) block.
        strip = lax.dynamic_slice(
            padded, (y0, 0, 0), (R + win - 1, w + 2 * pad, 3))
        cols = jnp.stack([
            lax.dynamic_slice_in_dim(strip, j, w, axis=1)
            for j in range(win)
        ])                                             # (win_j, R+win-1, W, 3)
        rows = jnp.stack([
            lax.slice_in_dim(cols, i, i + R, axis=1)
            for i in range(win)
        ])                                             # (win_i, win_j, R, W, 3)
        return jnp.transpose(rows, (2, 3, 0, 1, 4)).reshape(
            R * w, win, win, 3)

    def shear_band(G):
        """(R, W, W) Gram -> (R, W, D) band: out[r, x, d] = G[r, x, x+d]
        (zero past the last column). Pure pad/reshape/slice — a vmapped
        per-d dynamic_slice of the feature tensor materializes
        (D, R*W, F) = 27 GB at image scale; flattening with a stride of
        W+D+1 walks the diagonals with no gather."""
        Wp = w + D
        Gp = jnp.pad(G, ((0, 0), (0, 0), (0, D)))      # (R, W, Wp)
        flat = jnp.pad(Gp.reshape(R, w * Wp), ((0, 0), (0, w)))
        return flat.reshape(R, w, Wp + 1)[:, :, :D]

    def block_cost(y0):
        lw = block_windows(padded_l, y0)               # (R*W, win, win, 3)
        rw = block_windows(padded_r, y0)
        ls = vgg16_features_batched(params, lw)        # [(R*W, C, hs, ws)]
        rs = vgg16_features_batched(params, rw)
        total = jnp.zeros((R, D, w), jnp.float32)
        for fl, fr, lin in zip(ls, rs, lins):
            nl = jax.vmap(normalize_features)(fl)
            nr = jax.vmap(normalize_features)(fr)
            sp = nl.shape[2] * nl.shape[3]
            lin = jnp.asarray(lin)[None, :, None, None]
            wl = nl * lin                              # lin folded into left
            t_l = jnp.sum(wl * nl, axis=(1, 2, 3)).reshape(R, w) / sp
            t_r = jnp.sum(nr * nr * lin, axis=(1, 2, 3)).reshape(R, w) / sp
            nlf = wl.reshape(R, w, -1)
            nrf = nr.reshape(R, w, -1)
            # cross terms as ONE batched matmul per block: the
            # candidate band is the first D diagonals of the (W, W) Gram
            G = jnp.einsum("rxf,ryf->rxy", nrf, nlf) / sp
            cross = shear_band(G)                      # (R, W, D)
            t_l_pad = jnp.pad(t_l, ((0, 0), (0, D)))
            tl_band = jax.vmap(
                lambda d: lax.dynamic_slice_in_dim(t_l_pad, d, w, axis=1)
            )(jnp.arange(D))                           # (D, R, W)
            total = total + (
                t_r[:, None, :] + jnp.moveaxis(tl_band, 0, 1)
                - 2.0 * jnp.moveaxis(cross, 2, 1))
        return jnp.where(valid[None], total, jnp.inf)

    _, blocks = lax.scan(
        lambda c, y0: (c, block_cost(y0)),
        jnp.int32(0), jnp.arange(n_blocks) * R,
    )                                                  # (nb, R, D, W)
    return blocks.reshape(n_blocks * R, D, w)[:h]


@functools.partial(jax.jit, static_argnames=("config",))
def windowed_smooth_argmin(
    cost: jnp.ndarray,           # (H, D, W) from windowed_lpips_cost_volume
    config: PerceptualConfig = PerceptualConfig(),
) -> jnp.ndarray:
    """The notebook's chunked multiplicative smoothing (cell 10) with its
    quirks: the previous-pixel term resets every ``chunk`` pixels and its
    argmin is clamped to ``min(prev, size)`` where size is the CURRENT
    pixel's candidate count; previous-row weighting is row-global. The
    in-chunk recurrence runs Jacobi sweeps to the fixpoint (exact; chains
    cannot cross chunk resets, so <= chunk sweeps)."""
    h, D, w = cost.shape
    chunk = config.chunk
    bias, sigma = config.smoothing_bias, config.smoothing_sigma
    xs = jnp.arange(w)
    sizes = jnp.minimum(D, w - xs)
    dvals = jnp.arange(D, dtype=jnp.float32)
    pos_in_chunk = xs % chunk

    def row_step(prev_disp, inputs):
        cost_row, first = inputs
        up = (1.0 - jnp.exp(-jnp.abs(dvals[:, None] - prev_disp[None, :])
                            / sigma)) + bias
        cu = cost_row * jnp.where(first, 1.0, up)

        def resolve(left_arg):                         # (W,) float; nan=none
            mean = jnp.minimum(left_arg, sizes.astype(jnp.float32))
            wl = (1.0 - jnp.exp(-jnp.abs(dvals[:, None] - mean[None, :])
                                / sigma)) + bias
            use = (~jnp.isnan(left_arg)) & (pos_in_chunk > 0)
            c = cu * jnp.where(use[None, :], wl, 1.0)
            return jnp.argmin(c, axis=0).astype(jnp.float32)

        def sweep(d):
            la = jnp.concatenate([jnp.full((1,), jnp.nan), d[:-1]])
            return resolve(la)

        disp = resolve(jnp.full((w,), jnp.nan))

        def cond(s):
            d, p, it = s
            return jnp.any(d != p) & (it < chunk)

        def body(s):
            d, _, it = s
            return sweep(d), d, it + 1

        disp, _, _ = lax.while_loop(
            cond, body, (sweep(disp), disp, jnp.int32(1)))
        return disp, disp

    first_flags = jnp.zeros((h,), bool).at[0].set(True)
    _, disp = lax.scan(
        row_step, jnp.zeros((w,), jnp.float32), (cost, first_flags))
    return disp


def windowed_lpips_search(
    params: Dict,
    left: jnp.ndarray,      # (H, W, 3) RGB [0, 255]
    right: jnp.ndarray,     # (H, W, 3)
    config: PerceptualConfig = PerceptualConfig(),
) -> jnp.ndarray:
    """The notebook's per-window LPIPS search, notebook-exact semantics
    (tests/test_perceptual.py pins 100% argmin agreement vs the literal
    oracle): row-blocked batched cost volume + chunked smoothing scan."""
    return windowed_smooth_argmin(
        windowed_lpips_cost_volume(params, left, right, config), config)
