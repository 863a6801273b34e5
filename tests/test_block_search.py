"""Validate the device block search against the literal NumPy oracle of the
reference BlockSearch (see stereo_reconstruction/oracle.py).

Small random images keep the O(H*W*D*B^2) loop oracle tractable; natural
image crops are covered by the integration test in test_pipeline_config1.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction import oracle
from stereo_reconstruction.config import MatcherConfig
from stereo_reconstruction.ops import block_search, cost_volume as cv, smoothing


def _random_stereo(rng, h=40, w=56, max_d=12, noise=6):
    """A synthetic stereo pair: right image is the left shifted by a
    smoothly varying disparity + noise, with a black border strip."""
    left = rng.integers(10, 250, (h, w, 3)).astype(np.float64)
    # smooth it so windows are discriminative
    for _ in range(2):
        left = (left + np.roll(left, 1, 0) + np.roll(left, 1, 1) + np.roll(left, -1, 0)) / 4
    left = left.astype(np.uint8)
    disp_true = (max_d / 2 + (max_d / 3) * np.sin(np.arange(w) / 7))[None, :].repeat(h, 0)
    xs = np.arange(w)[None, :].repeat(h, 0)
    src = np.clip(xs + np.round(disp_true).astype(int), 0, w - 1)
    right = left[np.arange(h)[:, None], src]
    right = np.clip(
        right.astype(np.int64) + rng.integers(-noise, noise, right.shape), 1, 255
    ).astype(np.uint8)
    right[:, :2] = 0  # black strip like warped borders
    return left, right


def test_cost_volume_right_matches_oracle(rng):
    left, right = _random_stereo(rng, h=24, w=32, max_d=8)
    want = oracle.cost_volume_right(left, right, block_size=7, min_disparity=0, max_disparity=10)
    got = np.asarray(
        cv.cost_volume_right_ssd(
            jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
            block_size=7, min_disparity=0, max_disparity=10,
        )
    )
    got_hwd = np.moveaxis(got, 0, -1)
    # identical +inf pattern
    np.testing.assert_array_equal(np.isinf(got_hwd), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got_hwd[finite], want[finite], rtol=1e-5, atol=1e-4)


def test_block_search_right_matches_loop_oracle(rng):
    left, right = _random_stereo(rng, h=28, w=40, max_d=8)
    cfg = MatcherConfig(block_size=7, min_disparity=0, max_disparity=10,
                        smooth_factor=0.9, row_smooth_iters=2)
    want = oracle.block_search_right_loop(
        left, right, block_size=7, min_disparity=0, max_disparity=10, smooth_factor=0.9
    )
    got = np.asarray(block_search.block_search_right(
        jnp.asarray(left), jnp.asarray(right), cfg
    ))
    agree = np.mean(got == want)
    assert agree > 0.99, f"only {agree:.3%} pixels agree with the reference oracle"


def test_block_search_right_fast_oracle_consistent(rng):
    """The vectorized oracle tier must equal the literal loop tier."""
    left, right = _random_stereo(rng, h=20, w=30, max_d=6)
    a = oracle.block_search_right_loop(
        left, right, block_size=5, min_disparity=0, max_disparity=8
    )
    b = oracle.block_search_right_fast(
        left, right, block_size=5, min_disparity=0, max_disparity=8
    )
    np.testing.assert_array_equal(a, b)


def test_block_search_left_matches_loop_oracle(rng):
    left, right = _random_stereo(rng, h=24, w=36, max_d=6)
    cfg = MatcherConfig(block_size=5, max_disparity=8, smooth_factor=0.9,
                        row_smooth_iters=2)
    want = oracle.block_search_left_loop(
        left, right, block_size=5, max_disparity=8, smooth_factor=0.9
    )
    got = np.asarray(block_search.block_search_left(
        jnp.asarray(left), jnp.asarray(right), cfg
    ))
    agree = np.mean(got == want)
    assert agree > 0.97, f"only {agree:.3%} pixels agree with the reference oracle"


def test_black_pixels_get_zero(rng):
    left, right = _random_stereo(rng)
    cfg = MatcherConfig(block_size=7, max_disparity=10)
    got = np.asarray(block_search.block_search_right(jnp.asarray(left), jnp.asarray(right), cfg))
    assert (got[:, :2] == 0).all()


def test_no_candidate_sentinel():
    """Pixels too close to the right edge of the left image keep
    minimumCorrespondX=0 -> disparity -x (BlockSearch.cpp:111,174)."""
    h, w = 12, 16
    left = np.full((h, 8, 3), 100, np.uint8)   # narrow left image
    right = np.full((h, w, 3), 100, np.uint8)
    want = oracle.block_search_right_loop(left, right, block_size=5,
                                          min_disparity=0, max_disparity=6)
    got = np.asarray(block_search.block_search_right(
        jnp.asarray(left), jnp.asarray(right),
        MatcherConfig(block_size=5, min_disparity=0, max_disparity=6),
    ))
    np.testing.assert_array_equal(got, want)


def test_texture_measure_matches_oracle(rng):
    left, right = _random_stereo(rng, h=16, w=20)
    tex = np.asarray(block_search.window_texture(jnp.asarray(right, jnp.float32), 5))
    for y, x in [(0, 0), (3, 4), (8, 10), (15, 19)]:
        l = min(x, 2); r = min(20 - x - 1, 2)
        u = min(y, 2); d = min(16 - y - 1, 2)
        want = oracle._texture(right, x, y, l, r, u, d)
        np.testing.assert_allclose(tex[y, x], want, rtol=1e-4, atol=0.5)


def test_sad_cost_recovers_shift(rng):
    """SAD cost (framework extension) recovers the synthetic disparity and
    matches a direct NumPy evaluation of |diff| window sums / area."""
    left, right = _random_stereo(rng, h=24, w=40, max_d=8, noise=2)
    cfg = MatcherConfig(block_size=7, min_disparity=0, max_disparity=10,
                        smooth_factor=0.9, row_smooth_iters=2, cost="sad")
    got = np.asarray(block_search.block_search_right(
        jnp.asarray(left), jnp.asarray(right), cfg
    ))
    assert got.shape == (24, 40)
    # direct check of one plane: d = 3
    d = 3
    vol = np.asarray(cv.cost_volume_right_sad(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        block_size=7, min_disparity=0, max_disparity=10,
    ))
    h, w = right.shape[:2]
    hbs = 3
    diff = np.zeros((h, w))
    shifted = np.zeros_like(left, np.float64)
    shifted[:, : w - d] = left[:, d:]
    diff = np.abs(shifted - right.astype(np.float64)).sum(-1)
    want = np.full((h, w), np.inf)
    for y in range(h):
        for x in range(w):
            y0, y1 = max(0, y - hbs), min(h - 1, y + hbs)
            x0, x1 = max(0, x - hbs), min(w - 1, x + hbs)
            area = (y1 - y0) * (x1 - x0)
            rgt = min(w - 1 - x, hbs)
            if area > 0 and x + d + rgt < left.shape[1]:
                want[y, x] = diff[y0:y1, x0:x1].sum() / area
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(vol[d]), finite)
    np.testing.assert_allclose(vol[d][finite], want[finite], rtol=1e-5, atol=1e-4)


def _sequential_reference_smoothing_f32(cost, black, sf=0.9, d_first=0):
    """Literal row-major recurrence of BlockSearch's Right-variant
    smoothing (BlockSearch.cpp:160-171) at f32 multiply precision —
    the exactness target for smoothed_argmin_reference."""
    D, h, w = cost.shape
    sf = np.float32(sf)
    dvals = np.arange(d_first, d_first + D, dtype=np.float32)
    disp = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            if black[y, x]:
                disp[y, x] = 0.0
                continue
            c = cost[:, y, x].astype(np.float32).copy()
            if y >= 1:
                c[dvals == -disp[y - 1, x]] *= sf
            if x >= 1:
                c[dvals == -disp[y, x - 1]] *= sf
            i = int(np.argmin(c))
            disp[y, x] = dvals[i] if np.isfinite(c[i]) else -np.float32(x)
    return disp


def test_fast_reference_smoothing_exact_vs_sequential(rng):
    """smoothed_argmin_reference resolves the in-row recurrence with a
    3-state associative scan — must be bit-identical to the literal
    sequential recurrence, not an approximation."""
    for trial in range(3):
        D, h, w = 12, 17, 23
        cost = rng.uniform(0.1, 10.0, (D, h, w)).astype(np.float32)
        # invalid candidates, whole-invalid columns, exact ties, and a
        # cheap d=0 plane so discounts actually flip winners
        cost[rng.uniform(size=cost.shape) < 0.2] = np.inf
        cost[:, 3, 5:9] = np.inf
        cost[2, :, :] = cost[7, :, :]
        cost[0] = np.where(rng.uniform(size=(h, w)) < 0.3, 0.5, cost[0])
        black = rng.uniform(size=(h, w)) < 0.1
        want = _sequential_reference_smoothing_f32(cost, black)
        got = np.asarray(smoothing.smoothed_argmin_reference(
            jnp.asarray(cost), jnp.asarray(black),
            smooth_factor=0.9, d_first=0,
        ))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_fast_reference_smoothing_min_disparity_offset(rng):
    D, h, w = 9, 11, 30
    cost = rng.uniform(0.1, 10.0, (D, h, w)).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.3] = np.inf
    black = np.zeros((h, w), bool)
    want = _sequential_reference_smoothing_f32(cost, black, d_first=3)
    got = np.asarray(smoothing.smoothed_argmin_reference(
        jnp.asarray(cost), jnp.asarray(black),
        smooth_factor=0.9, d_first=3,
    ))
    np.testing.assert_array_equal(got, want)


def _sequential_smoothing_any_mode(cost, black, sf=0.9, mode="intended",
                                   variant="left", dvals=None):
    """Literal row-major recurrence for ANY smoothing mode/variant (the
    Left-variant +d semantics, BlockSearch.cpp:68-79, or the Right sign
    quirk) — the exactness target for smoothed_argmin(iters=None)."""
    D, h, w = cost.shape
    sf = np.float32(sf)
    sign = np.float32(-1.0 if mode == "reference" else 1.0)
    dvals = (np.arange(D, dtype=np.float32) if dvals is None
             else np.asarray(dvals, np.float32))
    sent = (-np.arange(w, dtype=np.float32) if variant == "right"
            else np.arange(w, dtype=np.float32))
    disp = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            if black[y, x]:
                disp[y, x] = 0.0
                continue
            c = cost[:, y, x].astype(np.float32).copy()
            if y >= 1:
                c[dvals == sign * disp[y - 1, x]] *= sf
            if x >= 1:
                c[dvals == sign * disp[y, x - 1]] *= sf
            i = int(np.argmin(c))
            disp[y, x] = dvals[i] if np.isfinite(c[i]) else sent[x]
    return disp


@pytest.mark.parametrize("mode,variant", [("intended", "left"),
                                          ("intended", "right"),
                                          ("reference", "right")])
def test_fixpoint_smoothing_exact_vs_sequential(rng, mode, variant):
    """smoothed_argmin(iters=None) runs the in-row Jacobi sweeps to their
    fixpoint — exact for EVERY mode (VERDICT r2 item 6: in intended mode
    the left neighbor's chosen d can be any plane, so no small automaton
    exists; the fixpoint is the sequential solution regardless)."""
    for trial in range(3):
        D, h, w = 8, 12, 18
        # small integer costs -> many exact ties -> long smoothing chains
        cost = (rng.integers(0, 4, (D, h, w)).astype(np.float32) + 1.0)
        cost[rng.uniform(size=cost.shape) < 0.15] = np.inf
        cost[:, 2, 4:7] = np.inf
        black = rng.uniform(size=(h, w)) < 0.1
        dvals = np.arange(1, D + 1, dtype=np.float32)
        want = _sequential_smoothing_any_mode(
            cost, black, sf=0.9, mode=mode, variant=variant, dvals=dvals)
        got = np.asarray(smoothing.smoothed_argmin(
            jnp.asarray(cost), jnp.asarray(dvals), jnp.asarray(black),
            smooth_factor=0.9, mode=mode, iters=None, variant=variant,
        ))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
