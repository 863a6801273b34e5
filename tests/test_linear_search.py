"""LinearSearch equivalence tests vs the literal NumPy oracle."""

import jax.numpy as jnp
import numpy as np

from stereo_reconstruction import oracle
from stereo_reconstruction.ops.linear_search import linear_search


def test_linear_search_matches_oracle(rng):
    h, w = 24, 40
    left = rng.integers(5, 250, (h, w, 3)).astype(np.uint8)
    right = np.roll(left, -3, axis=1)
    left[:, :2] = 0   # black strip (tested on the LEFT image — quirk)

    want = oracle.linear_search_loop(left, right, smooth_factor=0.9, search_range=8)
    got = np.asarray(
        linear_search(jnp.asarray(left), jnp.asarray(right),
                      smooth_factor=0.9, search_range=8)
    )
    agree = (got == want).mean()
    assert agree > 0.97, f"{agree:.3%}"


def test_linear_search_black_left_pixels_zero(rng):
    h, w = 12, 16
    left = np.zeros((h, w, 3), np.uint8)
    right = rng.integers(5, 250, (h, w, 3)).astype(np.uint8)
    got = np.asarray(linear_search(jnp.asarray(left), jnp.asarray(right), search_range=4))
    assert (got == 0).all()
