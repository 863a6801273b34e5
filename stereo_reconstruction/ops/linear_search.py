"""Linear (1x1-window) dense search — the reference's LinearSearch.

Equivalent of ``src/WindowSearch/LinearSearch.cpp:10-59``: per-pixel
RGB L2 distance over a fixed search band to the right, with the same
multiplicative smoothness reweighting (sign quirk included: the discount
compares the neighbor's disparity against ``j - k = -d``,
LinearSearch.cpp:39-44, while +d is stored).

Quirks preserved/documented:
  * the *left* image is tested for black pixels while the right image is
    being matched (LinearSearch.cpp:24) — reproduced;
  * candidates past the left image's width are skipped (the reference
    reads out of bounds there — deviation noted in oracle.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from stereo_reconstruction.ops import smoothing


def _with_channels(img: jnp.ndarray) -> jnp.ndarray:
    """Accept (H, W) grayscale by promoting to a single channel."""
    img = img.astype(jnp.float32)
    return img[..., None] if img.ndim == 2 else img


@functools.partial(jax.jit, static_argnames=("search_range",))
def cost_volume_linear(
    left: jnp.ndarray,     # (H, WL, 3) float32
    right: jnp.ndarray,    # (H, W, 3)
    search_range: int = 200,
) -> jnp.ndarray:
    """(D, H, W) per-pixel distance volume; +inf = invalid candidate."""
    left = _with_channels(left)
    right = _with_channels(right)
    h, w = right.shape[:2]
    wl = left.shape[1]

    pad_w = max(0, w + search_range - wl)
    left_p = jnp.pad(left, ((0, 0), (0, pad_w), (0, 0)))
    xs = jnp.arange(w)

    def one(d):
        shifted = lax.dynamic_slice_in_dim(left_p, d, w, axis=1)
        diff = shifted - right
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        valid = (xs[None, :] + d) < wl
        return jnp.where(valid, dist, jnp.inf)

    return jax.vmap(one)(jnp.arange(search_range))


@functools.partial(jax.jit, static_argnames=("search_range", "iters"))
def linear_search(
    left: jnp.ndarray,
    right: jnp.ndarray,
    smooth_factor: float = 0.9,
    search_range: int = 200,
    iters=None,   # None = in-row sweeps to fixpoint (exact, smoothing.py)
) -> jnp.ndarray:
    """(H, W) disparity of the right image (LinearSearch semantics)."""
    left = _with_channels(left)
    right = _with_channels(right)
    cost = cost_volume_linear(left, right, search_range)
    dvals = jnp.arange(search_range)
    # reference quirk: black-skip tests the LEFT image
    black = jnp.all(left[:, : right.shape[1]] == 0, axis=-1)
    disp = smoothing.smoothed_argmin(
        cost, dvals, black,
        smooth_factor=smooth_factor,
        mode="reference",
        iters=iters,
        variant="right",
    )
    h = min(left.shape[0], right.shape[0])
    rows_valid = jnp.arange(disp.shape[0]) < h
    return jnp.where(rows_valid[:, None], disp, 0.0)
