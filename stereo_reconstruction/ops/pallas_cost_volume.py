"""Fused dense-matcher kernel for NVIDIA GPUs (Pallas, Triton route).

The plain path (``cost_volume.cost_volume_right_ssd`` followed by
``smoothing.volume_reductions``) writes the whole (D, H, W) f32 cost volume
to device memory and reads it back several times for the five planes the
exact smoothing scan consumes. This kernel emits those five (H, W) planes
directly; the volume never leaves the block:

  grid = (row tiles, column tiles)            # T x T input tiles, TV x TV
                                              # outputs, TV = T - 2*hbs
  per block, for d in 0 .. D-1 (lax.fori_loop):
    1. load the left tile at column offset x + min_d + d and form the
       channel-summed squared difference against the (preloaded) right
       tile, zeroed outside the reference's window support
       (rows/cols outside [0, H-1) x [0, W-1), BlockSearch.cpp:116-123);
    2. window-sum it vertically and horizontally as two products with
       0/1 band matrices on the tensor cores. Each operand is split into
       three bf16 parts (hi + mid + lo == the f32 value), so every
       product is exact and, for integer-valued images, so is every sum
       below 2^24 (a 16 x 16 window whose channels differ by less than
       ~147 grey levels RMS);
    3. cost = sqrt(SSD) / area (BlockSearch.cpp:156-158), +inf where the
       candidate is invalid, folded into the running min / first-argmin,
       the d == 0 plane and the two sentinel diagonals.

On integer-valued images the five planes are bit-equal to the plain path
(tests/test_pallas_cost_volume.py in interpret mode; chip_smoke.py on the
card). Where sums pass 2^24, or on non-integer images (bilinear warps), the
window sums are taken in another order than XLA's, so costs can differ in
the last bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from stereo_reconstruction.config import MatcherConfig


def use_kernel(config: MatcherConfig, interpret: bool = False) -> bool:
    """The one place that chooses the dense matcher's backend.

    ``"xla"`` always takes the plain path. ``"auto"`` takes this kernel on
    a GPU when the configuration is one it covers (SSD cost, fixed block,
    ``min_disparity >= 0``) and the plain path otherwise. ``"pallas"``
    demands the kernel: it raises for a configuration the kernel does not
    cover, and on a platform it cannot be compiled for unless the caller
    asks for the Pallas interpreter explicitly (tests do).
    """
    if config.backend == "xla":
        return False
    if config.backend not in ("auto", "pallas"):
        raise ValueError(f"unknown matcher backend {config.backend!r}")
    covered = (not config.var_block and config.cost == "ssd"
               and config.min_disparity >= 0)
    on_gpu = jax.default_backend() == "gpu"
    if config.backend == "auto":
        return covered and on_gpu
    if not covered:
        raise ValueError(
            "backend='pallas' covers cost='ssd', var_block=False and "
            f"min_disparity >= 0 only; got {config}")
    if not (on_gpu or interpret):
        raise RuntimeError(
            "backend='pallas' needs a GPU; platform is "
            f"{jax.default_backend()!r} (interpret=True runs the kernel "
            "in the Pallas interpreter, for tests)")
    return True


# input tile side and warps per block: the fastest of 7 (tile, warps)
# pairs timed at 750x900, D=200 on an H100 (PERF.md)
TILE = 64
NUM_WARPS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split3(x):
    """Three bf16 parts whose f32 sum is exactly ``x``."""
    hi = x.astype(jnp.bfloat16)
    r = x - hi.astype(jnp.float32)
    mid = r.astype(jnp.bfloat16)
    lo = (r - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, mid, lo


def _dot(a, b):
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


def _kernel(l_ref, r_ref, rowok_ref, colok_ref, inv_ref, jlim_ref,
            m0_ref, a0_ref, cz_ref, du_ref, dl_ref,
            *, T: int, TV: int, hw: int, D: int, min_d: int):
    y0 = pl.program_id(0) * TV
    x0 = pl.program_id(1) * TV
    rows = pl.ds(y0, T)
    cols = pl.ds(x0, T)
    f32 = jnp.float32

    ok = (rowok_ref[rows][:, None] > 0) & (colok_ref[cols][None, :] > 0)
    right = [r_ref[c, rows, cols] for c in range(3)]
    inv_area = inv_ref[rows, cols]
    jlim = jlim_ref[rows, cols]
    ri = lax.broadcasted_iota(jnp.int32, (T, T), 0)
    ci = lax.broadcasted_iota(jnp.int32, (T, T), 1)
    # vertical: out row r sums tile rows r .. r+hw-1;
    # horizontal: out col c sums tile cols c .. c+hw-1
    band_v = ((ci >= ri) & (ci < ri + hw)).astype(jnp.bfloat16)
    band_h = ((ri >= ci) & (ri < ci + hw)).astype(jnp.bfloat16)
    xg = x0 + ci
    inf = jnp.full((T, T), jnp.inf, f32)

    def body(j, carry):
        m0, a0, cz, du, dl = carry
        lcols = pl.ds(x0 + min_d + j, T)
        dsq = jnp.zeros((T, T), f32)
        for c in range(3):
            diff = l_ref[c, rows, lcols] - right[c]
            dsq = dsq + diff * diff
        dsq = jnp.where(ok, dsq, 0.0)
        hi, mid, lo = _split3(dsq)
        v = _dot(band_v, hi) + _dot(band_v, mid) + _dot(band_v, lo)
        hi, mid, lo = _split3(v)
        s = _dot(hi, band_h) + _dot(mid, band_h) + _dot(lo, band_h)
        cost = jnp.where(j < jlim, jnp.sqrt(jnp.maximum(s, 0.0)) * inv_area,
                         jnp.inf)
        better = cost < m0
        m0 = jnp.where(better, cost, m0)
        a0 = jnp.where(better, j, a0)
        if min_d == 0:
            cz = jnp.where(j == 0, cost, cz)
        du = jnp.where(xg == j + min_d, cost, du)
        dl = jnp.where(xg - 1 == j + min_d, cost, dl)
        return m0, a0, cz, du, dl

    init = (inf, jnp.zeros((T, T), jnp.int32), inf, inf, inf)
    outs = lax.fori_loop(0, D, body, init)
    keep = (ri < TV) & (ci < TV)
    for ref, val in zip((m0_ref, a0_ref, cz_ref, du_ref, dl_ref), outs):
        plgpu.store(ref.at[rows, cols], val, mask=keep)


@functools.partial(
    jax.jit,
    static_argnames=("block_size", "min_disparity", "max_disparity",
                     "interpret"),
)
def pallas_matcher_inputs(
    left: jnp.ndarray,    # (H, W_l, 3)
    right: jnp.ndarray,   # (H, W, 3)
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    interpret: bool = False,
    row_offset=0,         # global index of local row 0 (may be traced)
    total_height=None,    # global image height (None -> H)
):
    """The five (H, W) inputs of the exact smoothing row scan
    (ops/smoothing.py ``smoothed_argmin_from_inputs``), with the cost
    volume never written out:

      m0       min over D of the cost volume
      a0       first-argmin plane index (int32)
      c_zero   the d == 0 plane (+inf everywhere if 0 is not in range)
      diag_up  cost[x - min_disparity, y, x]   (+inf out of range)
      diag_lf  cost[x-1-min_disparity, y, x]   (+inf out of range)

    ``row_offset``/``total_height`` switch the window geometry to GLOBAL
    row coordinates for halo-extended row tiles of a larger image (the
    sharded matcher, parallel/sharded.py). When ``0 < row_offset`` (resp.
    the tile does not reach the image bottom) the FIRST (resp. LAST)
    ``2*hbs`` output rows read local zero padding as if it were image
    content; the caller discards them.
    """
    if min_disparity < 0:
        raise ValueError("the fused kernel needs min_disparity >= 0")
    f32 = jnp.float32
    H, W = right.shape[:2]
    WL = left.shape[1]
    hbs = (block_size - 1) // 2
    hw = 2 * hbs
    D = max_disparity - min_disparity
    T = TILE                                  # doubled for large windows
    while T - hw < T // 4:
        T *= 2
    TV = T - hw
    nr, nc = _cdiv(H, TV), _cdiv(W, TV)
    Ho, Wo = nr * TV + hw, nc * TV + hw       # every tile load/store in bounds
    WLp = Wo + min_disparity + D
    h_tot = H if total_height is None else total_height

    # channel-major planes, padded by hbs on the top/left so that tile row
    # (col) k of the block at output row y0 (col x0) is image row
    # y0 - hbs + k (col x0 - hbs + k); the left image's plane-d columns
    # start min_disparity + d further right
    def planes(img, rows_out, cols_out):
        img = jnp.moveaxis(img.astype(f32), -1, 0)[:, :, : cols_out - hbs]
        return jnp.pad(img, ((0, 0), (hbs, rows_out - hbs - img.shape[1]),
                             (hbs, cols_out - hbs - img.shape[2])))

    lp = planes(left, Ho, WLp)
    rp = planes(right, Ho, Wo)

    # window support: global rows [0, h_tot - 1), cols [0, W - 1)
    g_rows = row_offset + jnp.arange(Ho) - hbs
    rowok = ((g_rows >= 0) & (g_rows < h_tot - 1)).astype(jnp.int32)
    g_cols = jnp.arange(Wo) - hbs
    colok = ((g_cols >= 0) & (g_cols < W - 1)).astype(jnp.int32)

    # per-output-pixel clipped window area and the number of valid planes
    # (candidate x + min_d + d + right extent < W_l, BlockSearch.cpp:148-149)
    yg = row_offset + jnp.arange(Ho)
    xs = jnp.arange(Wo)
    up = jnp.clip(jnp.minimum(yg, hbs), 0)
    down = jnp.clip(jnp.minimum(h_tot - 1 - yg, hbs), 0)
    lft = jnp.minimum(xs, hbs)
    rgt = jnp.minimum(W - 1 - xs, hbs)
    in_img = (yg >= 0) & (yg < h_tot)
    area = ((lft + rgt)[None, :] * jnp.where(in_img, up + down, 0)[:, None]
            ).astype(f32)
    inv_area = jnp.where(area > 0, 1.0 / jnp.maximum(area, 1.0), jnp.inf)
    jlim = jnp.where(area > 0,
                     jnp.clip(WL - min_disparity - xs - rgt, 0, D)[None, :],
                     0).astype(jnp.int32)

    kernel = functools.partial(_kernel, T=T, TV=TV, hw=hw, D=D,
                               min_d=min_disparity)
    plane = jax.ShapeDtypeStruct((Ho, Wo), f32)
    m0, a0, cz, du, dl = pl.pallas_call(
        kernel,
        grid=(nr, nc),
        out_shape=[plane, jax.ShapeDtypeStruct((Ho, Wo), jnp.int32),
                   plane, plane, plane],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="fused_matcher_inputs",
    )(lp, rp, rowok, colok, inv_area, jlim)
    return tuple(x[:H, :W] for x in (m0, a0, cz, du, dl))
