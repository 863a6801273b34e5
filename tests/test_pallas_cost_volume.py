"""Fused matcher kernel (ops/pallas_cost_volume.py) against the plain path.

On the CPU the kernel runs in the Pallas interpreter; the compiled kernel
on a GPU is checked by the ``gpu`` test below and by chip_smoke.py. On
integer-valued images both paths compute exact integer window sums, so the
five smoothing-scan inputs must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction import oracle
from stereo_reconstruction.config import MatcherConfig
from stereo_reconstruction.ops import cost_volume as cv
from stereo_reconstruction.ops import smoothing
from stereo_reconstruction.ops.block_search import block_search_right
from stereo_reconstruction.ops.pallas_cost_volume import pallas_matcher_inputs

from test_block_search import _random_stereo


def _plain_inputs(left, right, bs, min_d, max_d):
    cost = cv.cost_volume_right_ssd(jnp.asarray(left, jnp.float32),
                                    jnp.asarray(right, jnp.float32),
                                    bs, min_d, max_d)
    return [np.asarray(x) for x in smoothing.volume_reductions(cost, min_d)]


def _kernel_inputs(left, right, bs, min_d, max_d, **kw):
    return [np.asarray(x) for x in pallas_matcher_inputs(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        bs, min_d, max_d, interpret=True, **kw)]


@pytest.mark.parametrize("h,w,extra_wl,min_d,max_d,bs", [
    (21, 40, 9, 0, 10, 7),      # left wider than right
    (21, 40, 9, 2, 12, 5),      # min_disparity > 0: no d == 0 plane
    (70, 90, 0, 0, 30, 17),     # several row and column tiles
    (33, 57, 0, 3, 20, 9),      # odd sizes, one partial tile each way
])
def test_pallas_matcher_inputs_match_volume_reductions(rng, h, w, extra_wl,
                                                        min_d, max_d, bs):
    left, right = _random_stereo(rng, h=h, w=w, max_d=8)
    left = np.pad(left, ((0, 0), (0, extra_wl), (0, 0)))
    got = _kernel_inputs(left, right, bs, min_d, max_d)
    want = _plain_inputs(left, right, bs, min_d, max_d)
    for name, g, w_ in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"),
                           got, want):
        assert g.shape == (h, w), name
        np.testing.assert_array_equal(g, w_, err_msg=name)
    assert got[1].dtype == np.int32


def test_pallas_matcher_inputs_exact_below_2_24(rng):
    """Extreme images: window sums up to 256 * 3 * 128^2 < 2^24 stay exact
    (bit-equal); with 0/255 extremes they pass 2^24, where f32 sums round
    and the two summation orders may differ in the last bit only."""
    left = rng.choice([0, 128], (40, 80, 3)).astype(np.float32)
    right = rng.choice([0, 128], (40, 80, 3)).astype(np.float32)
    for g, w in zip(_kernel_inputs(left, right, 17, 0, 24),
                    _plain_inputs(left, right, 17, 0, 24)):
        np.testing.assert_array_equal(g, w)
    left, right = left * (255 / 128), right * (255 / 128)
    got = _kernel_inputs(left, right, 17, 0, 24)
    want = _plain_inputs(left, right, 17, 0, 24)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g, w, rtol=2.5e-7)   # 2 ulp of the sum


def test_large_window_takes_a_larger_tile(rng):
    """A 51-px window leaves too few outputs in a 64-px tile, so the
    wrapper doubles the tile; the result stays bit-equal."""
    left, right = _random_stereo(rng, h=60, w=70, max_d=8)
    for g, w in zip(_kernel_inputs(left, right, 51, 0, 12),
                    _plain_inputs(left, right, 51, 0, 12)):
        np.testing.assert_array_equal(g, w)


def test_global_row_coordinates_match_full_image(rng):
    """A halo-extended row tile in global coordinates reproduces the full
    image's planes on its interior rows (the sharded matcher's contract)."""
    left, right = _random_stereo(rng, h=48, w=40, max_d=6)
    full = _kernel_inputs(left, right, 5, 0, 10)
    r0, r1, hw = 12, 36, 4
    tile = _kernel_inputs(left[r0 - hw:r1 + hw], right[r0 - hw:r1 + hw],
                          5, 0, 10, row_offset=r0 - hw, total_height=48)
    for f, t in zip(full, tile):
        np.testing.assert_array_equal(t[hw:-hw], f[r0:r1])


def test_block_search_pallas_backend_matches_loop_oracle(rng):
    """block_search_right with backend='pallas' (interpreted here)
    reproduces the sequential reference recurrence."""
    left, right = _random_stereo(rng, h=28, w=40, max_d=8)
    cfg = MatcherConfig(block_size=7, min_disparity=0, max_disparity=10,
                        smooth_factor=0.9, backend="pallas")
    got = np.asarray(block_search_right(jnp.asarray(left), jnp.asarray(right),
                                        cfg, interpret=True))
    want = oracle.block_search_right_loop(
        left, right, block_size=7, min_disparity=0, max_disparity=10,
        smooth_factor=0.9)
    assert (got == want).mean() > 0.99
    xla = np.asarray(block_search_right(
        jnp.asarray(left), jnp.asarray(right),
        MatcherConfig(block_size=7, max_disparity=10, backend="xla")))
    np.testing.assert_array_equal(got, xla)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_path_on_gpu(gpu_device, rng):
    left, right = _random_stereo(rng, h=120, w=160, max_d=8)
    with jax.default_device(gpu_device):
        got = [np.asarray(x) for x in pallas_matcher_inputs(
            jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
            17, 0, 32)]
        want = _plain_inputs(left, right, 17, 0, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
