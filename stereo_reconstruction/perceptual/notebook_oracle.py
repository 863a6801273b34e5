"""Literal-semantics port of the reference perceptual window search.

This is the *oracle* for BASELINE config 3: a faithful re-implementation
of ``perceptual_window_search/Perceptual_window_search.ipynb`` cells
6-10, used only to score how closely the re-design
(``perceptual/cost.py`` — full-image features + shifted diffs) tracks
the notebook's per-window LPIPS search with identical VGG weights.
It is never on a production path (per-window VGG forwards are exactly
the O(H·W) network evaluations the re-design removes).

Notebook semantics reproduced here:
  * every pixel owns a ``window x window`` patch, zero-padded at image
    borders (cell 6: ``functional.unfold(kernel_size=17, padding=8)``);
  * each patch is forwarded through the VGG tower *independently* —
    border effects inside the 17x17 crop differ from full-image
    features, which is the approximation being measured;
  * LPIPS distance (cell 8 ``compute_distance``): per stage,
    channel-unit-normalize, squared difference, 1x1 ``lins`` weighting,
    spatial mean over the stage map, summed over the 5 stages;
  * for right pixel (y, x) the left candidates are columns
    ``x .. min(x + max_disparity, W) - 1`` of the same row (cell 10
    ``cut_idx``); the disparity stored is the argmin *index* d;
  * multiplicative smoothing (cell 10): scores are reweighted by
    ``(1 - exp(-|d - prev| / sigma)) + bias`` around the previous-row
    argmin (y > 0) and the previous-pixel argmin — with the notebook's
    quirks kept: the previous-pixel term only applies *within* a
    ``size_of_chunk``-pixel chunk (``argmins`` resets per chunk) and the
    neighbour index is clamped as ``min(argmins[-1], size)``.

Input scaling: the notebook feeds raw cv2 BGR 0..255 floats straight
into the LPIPS scaling layer (a quirk — LPIPS expects [-1, 1]).  Both
sides of the parity comparison here use the framework's documented
[0, 255] -> [-1, 1] -> scaling-layer convention (``vgg.vgg16_features``)
so the score isolates the *structural* approximation (windowed vs
full-image features, chunked vs row-global smoothing), not an input
convention.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.perceptual.vgg import (
    normalize_features,
    vgg16_features,
)


@functools.partial(jax.jit, static_argnames=("window", "padding"))
def _row_window_features(params: Dict, image: jnp.ndarray, y: jnp.ndarray,
                         window: int = 17, padding: int = 8):
    """Per-window VGG stages for every pixel of row ``y``.

    image: (H, W, 3) RGB float [0, 255]. Returns a list of 5 arrays
    (W, C_s, h_s, w_s) — the notebook's ``compute_row_embeddings`` with
    the windows forwarded through the same tower as the production path.
    """
    h, w = image.shape[:2]
    padded = jnp.pad(image, ((padding, padding), (padding, padding), (0, 0)))

    def one_window(x):
        win = jax.lax.dynamic_slice(
            padded, (y, x, 0), (window, window, 3)
        )  # top-left of window (y-8, x-8) in original coords
        return vgg16_features(params, win)

    return jax.vmap(one_window)(jnp.arange(w))


@jax.jit
def _row_distance_matrix(left_stages, right_stages, lins):
    """(W, W) LPIPS distances: D[x, xl] = lpips(right win x, left win xl).

    Cell 8 ``compute_distance``: per stage unit-normalize channels,
    squared diff, lins weighting, spatial average; summed over stages.
    """
    w = right_stages[0].shape[0]
    total = jnp.zeros((w, w), jnp.float32)
    for fl, fr, lin in zip(left_stages, right_stages, lins):
        nl = jax.vmap(normalize_features)(fl)    # (W, C, h, w)
        nr = jax.vmap(normalize_features)(fr)
        # d2[x, xl] = mean_hw( lin . (nl[xl] - nr[x])^2 )
        d2 = jnp.einsum(
            "c,xchw->xhw", jnp.asarray(lin), nr ** 2
        ).mean(axis=(1, 2))[:, None] + jnp.einsum(
            "c,xchw->xhw", jnp.asarray(lin), nl ** 2
        ).mean(axis=(1, 2))[None, :] - 2.0 * jnp.einsum(
            "xchw,ychw,c->xy", nr, nl, jnp.asarray(lin)
        ) / (nl.shape[2] * nl.shape[3])
        total = total + d2
    return total


def _weight_vector(size: int, mean_idx: float, sigma: float,
                   bias: float) -> np.ndarray:
    """Cell 8 ``weight_vector``."""
    idx = np.arange(size, dtype=np.float64)
    return (1.0 - np.exp(-np.abs(idx - float(mean_idx)) / sigma)) + bias


def notebook_window_search(
    params: Dict,
    left: np.ndarray,            # (H, W, 3) RGB float/uint8 [0, 255]
    right: np.ndarray,
    window: int = 17,
    padding: int = 8,
    max_disparity: int = 200,
    chunk: int = 20,
    smoothing_bias: float = 0.85,
    smoothing_sigma: float = 25.0,
    n_rows: int | None = None,
) -> np.ndarray:
    """The notebook's full window search (cell 10), row by row.

    Returns (H, W) float disparity (argmin indices, like the notebook's
    ``disparity_map``). ``n_rows`` limits the scan to the first rows —
    EXACT for those rows (the recurrence only looks upward), used by
    tools/perceptual_scale.py to measure per-row cost and prefix
    agreement at image scale without paying for every row.
    """
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    h, w = right.shape[:2]
    lins = params.get("lins") or [
        np.full((c,), 1.0 / c, np.float32)
        for c in (64, 128, 256, 512, 512)
    ]

    disparity = np.zeros((h, w), np.float32)
    for y in range(h if n_rows is None else min(n_rows, h)):
        ls = _row_window_features(params, left, jnp.int32(y), window, padding)
        rs = _row_window_features(params, right, jnp.int32(y), window, padding)
        dist = np.asarray(_row_distance_matrix(ls, rs, lins))  # (W, W)

        for x0 in range(0, w, chunk):
            argmins: list = []
            for x in range(x0, min(x0 + chunk, w)):
                cut = min(x + max_disparity, w)
                size = cut - x
                scores = dist[x, x:cut].astype(np.float64).copy()
                if y > 0:
                    scores *= _weight_vector(
                        size, disparity[y - 1, x],
                        smoothing_sigma, smoothing_bias)
                if argmins:
                    scores *= _weight_vector(
                        size, min(argmins[-1], size),
                        smoothing_sigma, smoothing_bias)
                argmins.append(int(np.argmin(scores)))
                disparity[y, x] = argmins[-1]
    return disparity


def notebook_rows(
    params: Dict,
    left: np.ndarray,
    right: np.ndarray,
    rows,                          # iterable of row indices y
    prev_disparity: np.ndarray,    # (H, W) previous-row context source
    window: int = 17,
    padding: int = 8,
    max_disparity: int = 200,
    chunk: int = 20,
    smoothing_bias: float = 0.85,
    smoothing_sigma: float = 25.0,
) -> Dict[int, np.ndarray]:
    """Oracle rows at ARBITRARY y, each conditioned on a caller-provided
    row y-1 (``prev_disparity``).

    The notebook recurrence makes row y depend on row y-1, so scattered
    rows cannot be oracle-computed in isolation; feeding the PRODUCTION
    backend's row y-1 as context makes the check exact FOR ROW y's
    semantics: if the backend matches the notebook, the oracle row
    produced from the backend's own context must equal the backend's row
    (VERDICT r4 #6 — widen image-scale verification beyond the prefix).
    Same quirks as notebook_window_search (per-chunk argmins reset,
    ``min(argmins[-1], size)`` clamp).
    """
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    h, w = right.shape[:2]
    lins = params.get("lins") or [
        np.full((c,), 1.0 / c, np.float32)
        for c in (64, 128, 256, 512, 512)
    ]

    out: Dict[int, np.ndarray] = {}
    for y in rows:
        ls = _row_window_features(params, left, jnp.int32(y), window, padding)
        rs = _row_window_features(params, right, jnp.int32(y), window, padding)
        dist = np.asarray(_row_distance_matrix(ls, rs, lins))  # (W, W)
        row = np.zeros((w,), np.float32)
        for x0 in range(0, w, chunk):
            argmins: list = []
            for x in range(x0, min(x0 + chunk, w)):
                cut = min(x + max_disparity, w)
                size = cut - x
                scores = dist[x, x:cut].astype(np.float64).copy()
                if y > 0:
                    scores *= _weight_vector(
                        size, prev_disparity[y - 1, x],
                        smoothing_sigma, smoothing_bias)
                if argmins:
                    scores *= _weight_vector(
                        size, min(argmins[-1], size),
                        smoothing_sigma, smoothing_bias)
                argmins.append(int(np.argmin(scores)))
                row[x] = argmins[-1]
        out[int(y)] = row
    return out
