"""Sharded dense matching: cost-volume row tiles across chips.

The BlockSearch hot loop's H dimension is sharded over the ``tile`` mesh
axis; window costs need halo rows from the row-wise neighbors, exchanged
with ``jax.lax.ppermute`` between devices (SURVEY.md §2 "Parallelism"
table).
Image-pair batches ride the ``data`` axis. Metric reductions are
``psum``s (sharded_evaldisp).

Exactness: the cost volume is computed with GLOBAL row coordinates
(cost_volume_right_ssd row_offset/total_height), so window clipping and
area normalization are bit-identical to the single-device result for
every kept row — tile edges are never mistaken for image borders.

Smoothing across tile boundaries: the reference's up-neighbor recurrence
is sequential over all rows; a sharded scan would serialize the tiles.
Each tile instead re-runs the recurrence over ``warmup`` extra rows above
its block (their cost planes come from the halo exchange) and keeps only
its own rows: the up-chain influence decays geometrically (the discount
only re-ranks near-tie candidates), so with the default warmup the
remaining divergence is confined to rare tie chains and is gated in
bad-2.0 terms on real pairs (tests/test_sharding.py). ``warmup >= rows
above the tile`` reproduces the single-device output exactly (the
equivalence test uses that mode). The in-row term is exact everywhere
(3-state associative scan, ops/smoothing.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from stereo_reconstruction.config import MatcherConfig
from stereo_reconstruction.ops import cost_volume as cv
from stereo_reconstruction.ops import pallas_cost_volume as pcv
from stereo_reconstruction.ops import smoothing


def _halo_exchange(block: jnp.ndarray, top_halo: int, bottom_halo: int,
                   axis_name: str) -> jnp.ndarray:
    """Pad a (Hloc, W, ...) row block with rows from the previous / next
    device along `axis_name` (zeros at the ends). ``top_halo`` may exceed
    Hloc-per-device only if <= Hloc (one-hop exchange)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    # my FIRST rows become the previous device's bottom halo; my LAST rows
    # become the next device's top halo
    send_up = block[:bottom_halo]
    send_down = block[-top_halo:]
    from_next = lax.ppermute(
        send_up, axis_name, [(i, (i - 1) % n) for i in range(n)])
    from_prev = lax.ppermute(
        send_down, axis_name, [(i, (i + 1) % n) for i in range(n)])

    # zero the wrapped ends (first tile has no rows above, last none below)
    from_prev = jnp.where(idx == 0, jnp.zeros_like(from_prev), from_prev)
    from_next = jnp.where(idx == n - 1, jnp.zeros_like(from_next), from_next)
    return jnp.concatenate([from_prev, block, from_next], axis=0)


@functools.lru_cache(maxsize=32)
def _build_sharded_matcher(mesh: Mesh, config: MatcherConfig, h: int,
                           warmup: int, exact: bool = False,
                           interpret: bool = False):
    """Cached jitted shard_map matcher — one compile per (mesh, config,
    height, warmup, exact); repeated calls reuse the XLA executable.

    ``exact`` selects the WAVEFRONT mode: instead of truncating the
    up-neighbor chain at ``warmup`` rows, the smoothing recurrence is
    chained across tiles — the only state row y needs from above is the
    final disparity row y-1 (a (W,) vector), so tile t's scan is re-run
    n_tiles times inside a fori_loop, reseeded each iteration by a
    ppermute of the up-tile's last row. Tile t's output is correct from
    iteration t on (seeds propagate monotonically), so after n_tiles
    iterations the result is BIT-IDENTICAL to the single-device matcher.
    The expensive cost-volume build stays fully row-parallel (computed
    once, outside the loop); only the cheap O(W)-per-row smoothing scan
    is repeated, so exactness costs ~n_tiles x smoothing, not n_tiles x
    matcher (measured in SCALING.json exact_mode rows)."""
    hbs = (config.block_size - 1) // 2
    hw = 2 * hbs
    n_tiles = mesh.shape["tile"]
    rows_per_tile = h // n_tiles
    if exact:
        warmup = 0
    top_halo = warmup + hw
    bottom_halo = hw
    D = config.max_disparity - config.min_disparity

    # the same backend choice as block_search_right; the fused kernel
    # takes global row coordinates, so the tile axis shards it as well
    use_pallas = pcv.use_kernel(config, interpret)

    def local(left_blk, right_blk):
        # left_blk/right_blk: (Bloc, Hloc, W, 3)
        def per_pair(lb, rb):
            lb_h = _halo_exchange(lb, top_halo, bottom_halo, "tile")
            rb_h = _halo_exchange(rb, top_halo, bottom_halo, "tile")
            idx = lax.axis_index("tile")
            row0 = idx * rows_per_tile - top_halo   # global id of local row 0

            black = cv.black_pixel_mask(rb_h[hw:-hw])
            gids = row0 + hw + jnp.arange(warmup + rows_per_tile)
            if exact:
                # only the true image top starts the chain; every other
                # tile-first row is seeded by the wavefront ppermute
                first = gids == 0
            else:
                # rows with no (available) up-neighbor: the true image top
                # and each tile's first warm-up row (the truncation point)
                first = (gids <= 0) | (
                    jnp.arange(warmup + rows_per_tile) == 0)

            if use_pallas:
                planes = pcv.pallas_matcher_inputs(
                    lb_h.astype(jnp.float32),
                    rb_h.astype(jnp.float32),
                    config.block_size,
                    config.min_disparity,
                    config.max_disparity,
                    interpret=interpret,
                    row_offset=row0,
                    total_height=h,
                )
                # drop the window-support-only rows (the kernel's
                # global-mode contract), keep the warm-up rows
                m0, a0, c_zero, diag_up, diag_lf = (
                    p[hw:-hw] for p in planes
                )
            else:
                cost = cv.cost_volume_right_ssd(
                    lb_h.astype(jnp.float32),
                    rb_h.astype(jnp.float32),
                    config.block_size,
                    config.min_disparity,
                    config.max_disparity,
                    row_offset=row0,
                    total_height=h,
                )                    # (D, top_halo + Hloc + hw, W) exact
                # keep warm-up rows for the smoothing recurrence; drop
                # the window-support-only rows
                m0, a0, c_zero, diag_up, diag_lf = (
                    smoothing.volume_reductions(
                        cost[:, hw:-hw, :], config.min_disparity))

            def smooth(seed):
                return smoothing.smoothed_argmin_from_inputs(
                    m0, a0, c_zero, diag_up, diag_lf, black,
                    smooth_factor=config.smooth_factor,
                    d_first=config.min_disparity,
                    n_planes=D,
                    first_flags=first,
                    init_prev=seed,
                )

            w = lb.shape[1]
            if not exact:
                return smooth(jnp.zeros((w,), jnp.float32))[warmup:]

            # wavefront: n_tiles reseeded smoothing passes; ppermute the
            # final local row down one tile after each (no wraparound —
            # tile 0 receives zeros and its seed is ignored via `first`)
            perm_down = [(i, i + 1) for i in range(n_tiles - 1)]

            def body(_t, state):
                seed, _ = state
                disp = smooth(seed)
                seed_next = lax.ppermute(disp[-1], "tile", perm_down)
                return seed_next, disp

            _, disp = lax.fori_loop(
                0, n_tiles, body,
                (jnp.zeros((w,), jnp.float32),
                 jnp.zeros((rows_per_tile, w), jnp.float32)))
            return disp

        return jax.vmap(per_pair)(left_blk, right_blk)

    spec_in = P("data", "tile", None, None)
    spec_out = P("data", "tile", None)
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec_in, spec_in), out_specs=spec_out,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_block_search_right(
    left: jnp.ndarray,      # (B, H, W, 3) batch of rectified pairs
    right: jnp.ndarray,     # (B, H, W, 3)
    mesh: Mesh,
    config: MatcherConfig = MatcherConfig(),
    warmup: int = 32,       # smoothing warm-up rows above each tile
    exact: bool = False,    # wavefront mode: bit-identical to 1 device
    interpret: bool = False,  # fused kernel in the Pallas interpreter
) -> jnp.ndarray:
    """(B, H, W) disparity; B sharded on `data`, H sharded on `tile`.

    ``exact=True`` chains the smoothing recurrence across tiles
    (wavefront ppermute of the boundary disparity row) instead of
    truncating it at ``warmup`` rows: bit-identical to the single-device
    matcher at ~n_tiles x the (cheap) smoothing-scan cost, with the
    cost-volume build still fully parallel. See _build_sharded_matcher."""
    hbs = (config.block_size - 1) // 2
    hw = 2 * hbs
    h = int(right.shape[1])
    rows_per_tile = h // mesh.shape["tile"]
    warmup = 0 if exact else min(warmup, rows_per_tile - hw)
    return _build_sharded_matcher(mesh, config, h, warmup, exact,
                                  interpret)(left, right)


@functools.lru_cache(maxsize=32)
def _build_sharded_evaldisp(mesh: Mesh, bad_thresh: float, max_disp: float):
    def local(d, g, m):
        d = d.astype(jnp.float32)
        g = g.astype(jnp.float32)
        known = jnp.isfinite(g)
        evaluated = known & (m == 255)
        valid = d != 0
        dd = jnp.where(valid, jnp.clip(d, 0.0, max_disp), d)
        err = jnp.abs(dd - g)

        n = jnp.sum(evaluated)
        n_valid = jnp.sum(evaluated & valid)
        bad = jnp.sum(evaluated & valid & (err > bad_thresh))
        serr = jnp.sum(jnp.where(evaluated & valid, err, 0.0))

        stats = jnp.stack([n, n_valid, bad, serr.astype(jnp.float32)])
        total = lax.psum(lax.psum(stats, "tile"), "data")
        n, n_valid, bad, serr = total[0], total[1], total[2], total[3]
        invalid = n - n_valid
        out = jnp.stack(
            [
                100.0 * bad / jnp.maximum(n, 1),
                100.0 * invalid / jnp.maximum(n, 1),
                100.0 * (bad + invalid) / jnp.maximum(n, 1),
                serr / jnp.maximum(n_valid, 1),
            ]
        )
        return out

    spec = P("data", "tile", None)
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=P(), check_vma=False,
    )
    return jax.jit(fn)


def sharded_evaldisp(
    disp: jnp.ndarray,      # (B, H, W) sharded like the matcher output
    gt: jnp.ndarray,
    mask: jnp.ndarray,
    mesh: Mesh,
    bad_thresh: float = 2.0,
    max_disp: float = 1e9,
):
    """Global Middlebury metrics over a sharded batch via psum."""
    fn = _build_sharded_evaldisp(mesh, float(bad_thresh), float(max_disp))
    vals = fn(disp, gt, mask)
    return {
        "bad_percent": vals[0],
        "invalid_percent": vals[1],
        "total_bad_percent": vals[2],
        "avg_err": vals[3],
    }
