"""Smoothness-reweighted argmin over the cost volume.

The reference interleaves a multiplicative smoothness discount with the
disparity argmin (BlockSearch.cpp:68-79,160-171): while scanning candidates
for pixel (y, x), a candidate's cost is multiplied by ``smoothFactor`` if
the up-neighbor (y-1, x) or left-neighbor (y, x-1) *already chose* that
disparity. This makes the result a sequential recurrence over pixels in
row-major order.

Data-parallel formulation:
  * rows are processed by a ``lax.scan`` (the up-neighbor term is exact:
    each row sees the previous row's final disparities, vectorized over W);
  * the in-row left-neighbor dependence is resolved by ``iters`` Jacobi
    sweeps: sweep k discounts against sweep k-1's left-shifted disparities.
    With iters>=2 this converges to the sequential result except on rare
    propagation chains; the residual disagreement is validated in tests to
    stay within the 0.5pp bad-2.0 budget (SURVEY.md hard-part #1).

Modes:
  * ``"reference"`` — bit-compatible with BlockSearch's Right variant,
    which (sign quirk, BlockSearch.cpp:160-165) compares the neighbor
    disparity against ``-d``; the discount thus fires essentially only at
    d == 0 next to disparity-0 neighbors.
  * ``"intended"``  — compares against ``+d`` (the Left-variant semantics,
    BlockSearch.cpp:68-73, and what the quirk plainly meant to do).
  * ``"none"``      — plain argmin.

No-candidate pixels (all costs +inf) keep the reference sentinel
``minimumCorrespondX = 0``: disparity = -x for the Right variant, +x for
Left. Black pixels are forced to disparity 0.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("iters", "d_first"))
def smoothed_argmin_reference(
    cost: jnp.ndarray,        # (D, H, W), +inf = invalid candidate
    black: jnp.ndarray,       # (H, W) bool: pixels forced to 0
    smooth_factor: float = 0.9,
    iters: int = 2,           # kept for API compat; the path is exact
    d_first: int = 0,         # dvals = d_first + arange(D); requires >= 0
    first_flags: Optional[jnp.ndarray] = None,  # (H,) rows with no up-neighbor
    init_prev: Optional[jnp.ndarray] = None,    # (W,) up-neighbor seed row
) -> jnp.ndarray:
    """EXACT fast path for ``mode="reference"``, Right variant.

    Two observations make the sequential reference recurrence
    (BlockSearch.cpp:160-171) parallelizable without approximation:

    1. With the sign quirk the discount fires where ``dvals ==
       -neighbor_disp``. Neighbor disparities are a chosen dval >= 0, a
       black-pixel 0, or the no-candidate sentinel ``-x``; with dvals >= 0
       the discount can only hit candidate d == 0 (neighbor chose 0) or
       d == x (neighbor is a sentinel). Since a discount only *lowers*
       isolated entries, the discounted argmin equals the lexicographic
       (value, index) min over three candidates: the plain argmin, the
       up-hit entry and the left-hit entry. All (D,H,W)-sized reductions
       (plain min/argmin + two fixed diagonal gathers) therefore batch
       OUTSIDE the row scan.
    2. The in-row dependence on the left neighbor collapses to a 3-state
       automaton: the left pixel's influence is fully described by
       case(left) in {none, chose-0, sentinel}. Each pixel's result is
       precomputed for all 3 input cases, the per-pixel case-transition
       tables are composed with an O(W log W) ``associative_scan``, and
       the true case selects the result — bit-identical to the sequential
       left-to-right recurrence (validated against the loop oracle in
       tests/test_block_search.py).

    The row scan (up-neighbor recurrence) body is O(W log W) with no
    D-sized work; the volume passes are fully parallel.
    """
    D = cost.shape[0]
    m0, a0, c_zero, diag_up, diag_lf = volume_reductions(cost, d_first)
    return smoothed_argmin_from_inputs(
        m0, a0, c_zero, diag_up, diag_lf, black,
        smooth_factor=smooth_factor, d_first=d_first, n_planes=D,
        first_flags=first_flags, init_prev=init_prev,
    )


@functools.partial(jax.jit, static_argnames=("d_first",))
def volume_reductions(cost: jnp.ndarray, d_first: int = 0):
    """The five (H, W) planes the exact smoothing scan consumes, batched
    over the whole volume (the heavy part, fully parallel): plain
    min/argmin, the d == 0 plane, and the two sentinel diagonals."""
    D, h, w = cost.shape
    m0 = jnp.min(cost, axis=0)                       # (H, W)
    a0 = jnp.argmin(cost, axis=0).astype(jnp.int32)  # first-index semantics
    # plane of candidate d == 0 (neighbor disparity 0)
    i_zero = -d_first
    c_zero = (
        cost[i_zero] if 0 <= i_zero < D else jnp.full((h, w), jnp.inf)
    )
    xi = jnp.arange(w)
    # diag extraction for sentinel neighbors: candidate d == x (up) and
    # d == x-1 (left), i.e. plane index varies along W only. A one-hot
    # contraction: one fused multiply+reduce pass over the volume instead
    # of a gather along its major axis.
    dplane = jnp.arange(D)
    finite_cost = jnp.where(jnp.isinf(cost), 0.0, cost)
    oh_up = (xi[None, :] == (dplane + d_first)[:, None]).astype(cost.dtype)
    oh_lf = ((xi - 1)[None, :] == (dplane + d_first)[:, None]).astype(cost.dtype)
    inf_up = jnp.einsum("dhw,dw->hw", jnp.isinf(cost).astype(cost.dtype), oh_up)
    inf_lf = jnp.einsum("dhw,dw->hw", jnp.isinf(cost).astype(cost.dtype), oh_lf)
    diag_up = jnp.einsum("dhw,dw->hw", finite_cost, oh_up)
    diag_lf = jnp.einsum("dhw,dw->hw", finite_cost, oh_lf)
    diag_up = jnp.where(
        (xi >= d_first) & (xi < d_first + D) & (inf_up == 0), diag_up, jnp.inf
    )
    diag_lf = jnp.where(
        (xi - 1 >= d_first) & (xi - 1 < d_first + D) & (inf_lf == 0),
        diag_lf, jnp.inf,
    )
    return m0, a0, c_zero, diag_up, diag_lf


@functools.partial(jax.jit, static_argnames=("d_first", "n_planes"))
def smoothed_argmin_from_inputs(
    m0: jnp.ndarray,          # (H, W) min over D
    a0: jnp.ndarray,          # (H, W) int32 first-argmin plane index
    c_zero: jnp.ndarray,      # (H, W) the d == 0 plane (+inf if no plane)
    diag_up: jnp.ndarray,     # (H, W) cost[x - d_first]   (+inf o.o.r.)
    diag_lf: jnp.ndarray,     # (H, W) cost[x-1-d_first]   (+inf o.o.r.)
    black: jnp.ndarray,       # (H, W) bool
    smooth_factor: float = 0.9,
    d_first: int = 0,
    n_planes: int = 1,
    first_flags: Optional[jnp.ndarray] = None,
    init_prev: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """The exact smoothing row scan from precomputed volume reductions.

    The five (H, W) inputs are produced either by the XLA front-end above
    or — with the full volume never written out — by the fused Pallas
    kernel (ops/pallas_cost_volume.py ``pallas_matcher_inputs``).

    ``init_prev`` seeds the up-neighbor carry for row 0 — a row tile
    whose first row should continue the recurrence from the tile above
    passes that tile's final disparity row here (and first_flags[0]
    False); the wavefront-exact sharded matcher (parallel/sharded.py)
    chains tiles this way."""
    h, w = m0.shape
    D = n_planes
    sf = jnp.float32(smooth_factor)
    xs = jnp.arange(w, dtype=jnp.float32)
    xi = jnp.arange(w)
    sentinel = -xs
    i_zero = -d_first
    i_lf = jnp.clip(xi - 1 - d_first, 0, D - 1).astype(jnp.int32)

    def lexmin(v1, i1, v2, i2):
        """(value, index) lexicographic min — first-argmin tie semantics."""
        take2 = (v2 < v1) | ((v2 == v1) & (i2 < i1))
        return jnp.where(take2, v2, v1), jnp.where(take2, i2, i1)

    def compose(a, b):
        """3-state transition composition: (b o a)[c] = b[a[c]] — written
        as arithmetic selects, no gathers."""
        a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
        b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]

        def app(c):
            return jnp.where(c == 0, b0, jnp.where(c == 1, b1, b2))

        return jnp.stack([app(a0), app(a1), app(a2)], axis=-1)

    def row_step(prev_disp, inputs):
        m0r, a0r, c0r, dur, dlr, black_row, first = inputs

        # up-neighbor candidate (exact: prev_disp is the final row above)
        up_zero = prev_disp == 0.0
        up_sent = prev_disp == -xs
        up_val = jnp.where(up_zero, c0r, jnp.where(up_sent, dur, jnp.inf))
        up_idx = jnp.where(up_zero, i_zero, jnp.clip(xi - d_first, 0, D - 1))
        v_u = jnp.where(first, jnp.inf, up_val * sf)

        def resolve(lf_val, lf_idx):
            both = (lf_idx == up_idx) & jnp.isfinite(v_u) & jnp.isfinite(lf_val)
            extra = jnp.where(both, sf, 1.0)
            best, bidx = lexmin(m0r, a0r, v_u * extra, up_idx)
            best, bidx = lexmin(best, bidx, lf_val * sf * extra, lf_idx)
            disp = jnp.where(
                jnp.isfinite(best), (d_first + bidx).astype(jnp.float32), sentinel
            )
            return jnp.where(black_row, 0.0, disp)

        inf_w = jnp.full((w,), jnp.inf)
        d_none = resolve(inf_w, jnp.full((w,), -1, jnp.int32))
        d_zero = resolve(c0r, jnp.full((w,), i_zero, jnp.int32))
        d_sent = resolve(dlr, i_lf)

        # per-pixel case transition g[x, c_in] = case(disp under c_in),
        # case: 0 = none, 1 = left chose 0, 2 = left is sentinel -x
        def case_of(d):
            return jnp.where(
                d == 0.0, 1, jnp.where(d == sentinel, 2, 0)
            ).astype(jnp.int32)

        g = jnp.stack([case_of(d_none), case_of(d_zero), case_of(d_sent)], -1)
        comp = lax.associative_scan(compose, g, axis=0)       # (W, 3)
        case_out = comp[:, 0]                                 # input: none @ x=0
        case_in = jnp.concatenate([jnp.zeros((1,), jnp.int32), case_out[:-1]])

        disp = jnp.where(
            case_in == 0, d_none, jnp.where(case_in == 1, d_zero, d_sent)
        )
        return disp, disp

    if first_flags is None:
        first_flags = jnp.zeros((h,), bool).at[0].set(True)
    if init_prev is None:
        init_prev = jnp.zeros((w,), jnp.float32)
    _, disparity = lax.scan(
        row_step,
        init_prev.astype(jnp.float32),
        (m0, a0, c_zero, diag_up, diag_lf, black, first_flags),
        unroll=8,   # the O(W) body is tiny; per-step loop overhead dominates
    )
    return disparity


@functools.partial(jax.jit, static_argnames=("mode", "iters", "variant"))
def smoothed_argmin(
    cost: jnp.ndarray,        # (D, H, W), +inf = invalid candidate
    dvals: jnp.ndarray,       # (D,) disparity value of each plane
    black: jnp.ndarray,       # (H, W) bool: pixels forced to 0
    smooth_factor: float = 0.9,
    mode: str = "reference",
    iters: Optional[int] = 2,
    variant: str = "right",
) -> jnp.ndarray:
    """Returns the (H, W) float32 disparity map.

    ``iters=None`` runs the in-row Jacobi sweeps to their FIXPOINT
    (``lax.while_loop``) instead of a fixed count — EXACT for every mode:
    a fixpoint d satisfies d[x] = resolve(cu, d[x-1]) for all x, i.e. the
    sequential left-to-right recurrence, whose forward substitution has a
    unique solution; sweep k reproduces at least the first k pixels of
    that solution, so convergence takes <= W sweeps (typically 2-4). This
    closes the "intended"-mode exactness gap (VERDICT r2 item 6): the
    +d-sign Left-variant semantics (BlockSearch.cpp:68-73) admit no small
    left-influence automaton (the neighbor's chosen d can be ANY plane),
    but the fixpoint iteration is exact without one
    (tests/test_block_search.py pins it against the loop oracle).
    """
    D, h, w = cost.shape
    dvals = dvals.astype(jnp.float32)
    xs = jnp.arange(w, dtype=jnp.float32)
    sentinel = -xs if variant == "right" else xs

    sign = -1.0 if mode == "reference" else 1.0

    def discounts(disp_neighbor):
        """(W,) neighbor disparities -> (D, W) multiplicative factors."""
        if mode == "none":
            return jnp.ones((D, w), cost.dtype)
        hit = dvals[:, None] == sign * disp_neighbor[None, :]
        return jnp.where(hit, smooth_factor, 1.0)

    nan_row = jnp.full((w,), jnp.nan, jnp.float32)

    def resolve(cu, left_disp):
        """argmin of the up-discounted cost with left-neighbor discounts."""
        c = cu * discounts(left_disp)
        idx = jnp.argmin(c, axis=0)
        best = jnp.min(c, axis=0)
        disp = jnp.where(jnp.isfinite(best), dvals[idx], sentinel)
        return disp

    def row_step(prev_disp, inputs):
        cost_row, black_row, first = inputs
        # up-discounted cost computed ONCE per row (the Jacobi sweeps only
        # vary the left-neighbor term)
        cu = cost_row * jnp.where(first, 1.0, discounts(prev_disp))

        # sweep 0: no left-neighbor discount (x=0 never has one; interior
        # pixels get it in later sweeps). Black pixels are forced to 0
        # after EVERY sweep so later sweeps see the final neighbor value,
        # exactly like the sequential reference recurrence does.
        disp = jnp.where(black_row, 0.0, resolve(cu, nan_row))

        def sweep(d):
            left_disp = jnp.concatenate([nan_row[:1], d[:-1]])
            return jnp.where(black_row, 0.0, resolve(cu, left_disp))

        if iters is None:
            # run to the fixpoint: exact (see docstring), <= W sweeps
            def cond(state):
                d, prev, it = state
                return jnp.any(d != prev) & (it < w)

            def body(state):
                d, _, it = state
                return sweep(d), d, it + 1

            disp, _, _ = lax.while_loop(
                cond, body, (sweep(disp), disp, jnp.int32(1))
            )
        else:
            for _ in range(max(0, iters - 1)):
                disp = sweep(disp)

        return disp, disp

    first_flags = jnp.zeros((h,), bool).at[0].set(True)
    init = jnp.zeros((w,), jnp.float32)
    _, disparity = lax.scan(
        row_step,
        init,
        (jnp.moveaxis(cost, 1, 0), black, first_flags),
        unroll=4,
    )
    return disparity


def plain_argmin(cost: jnp.ndarray, dvals: jnp.ndarray, black: jnp.ndarray,
                 variant: str = "right") -> jnp.ndarray:
    """Unsmoothed winner-take-all disparity (cheapest path)."""
    D, h, w = cost.shape
    idx = jnp.argmin(cost, axis=0)
    best = jnp.min(cost, axis=0)
    xs = jnp.arange(w, dtype=jnp.float32)
    sentinel = -xs if variant == "right" else xs
    disp = jnp.where(jnp.isfinite(best), dvals.astype(jnp.float32)[idx], sentinel[None, :])
    return jnp.where(black, 0.0, disp)
