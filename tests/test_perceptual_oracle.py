"""Config-3 parity: device perceptual matcher vs the notebook-semantics oracle.

The oracle (``perceptual/notebook_oracle.py``) is a literal port of the
reference notebook's windowed LPIPS search (Perceptual_window_search.ipynb
cells 6-10): per-window VGG forwards + chunk-quirk multiplicative
smoothing. The production path (``perceptual/cost.py``) replaces the
O(H*W) per-window network evaluations with full-image feature maps; this
test bounds the structural approximation with IDENTICAL He-init weights
on a synthetic constant-shift pair. The real-crop score lives in
``baselines/perceptual_parity.json`` (tools/perceptual_parity.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import PerceptualConfig
from stereo_reconstruction.perceptual import (
    init_vgg16_params,
    perceptual_window_search,
)
from stereo_reconstruction.perceptual.notebook_oracle import (
    _weight_vector,
    notebook_window_search,
)


def test_weight_vector_matches_notebook_formula():
    w = _weight_vector(10, 3.0, 25.0, 0.85)
    idx = np.arange(10.0)
    expected = (1.0 - np.exp(-np.abs(idx - 3.0) / 25.0)) + 0.85
    np.testing.assert_allclose(w, expected, rtol=1e-12)
    # minimum at the previous argmin (bias keeps it positive)
    assert w.argmin() == 3 and w.min() == pytest.approx(0.85)


@pytest.mark.slow
@pytest.mark.slow
def test_matcher_tracks_notebook_oracle_constant_shift():
    rng = np.random.default_rng(7)
    h, w, shift = 16, 32, 3   # h >= 16 keeps all 5 VGG stages non-empty
    right = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    left = np.roll(right, shift, axis=1)          # right[x] == left[x+3]

    params = init_vgg16_params(seed=0)
    cfg = PerceptualConfig(max_disparity=6)

    ref = notebook_window_search(params, left, right, max_disparity=6)
    ours = np.asarray(
        perceptual_window_search(params, jnp.asarray(left),
                                 jnp.asarray(right), cfg)
    )

    # interior: away from the wrap-around columns and window border band
    o = ours[:, shift:w - 8]
    r = ref[:, shift:w - 8]
    assert (r == shift).mean() > 0.8          # oracle recovers the shift
    assert (o == r).mean() > 0.7              # matcher tracks the oracle
    assert np.abs(o - r).mean() < 1.0


@pytest.mark.slow
def test_notebook_rows_consistent_with_full_scan():
    """notebook_rows (scattered-row verification mode, VERDICT r4 #6)
    must reproduce notebook_window_search's rows exactly when fed the
    full scan's own previous-row context."""
    from stereo_reconstruction.perceptual.notebook_oracle import (
        notebook_rows,
    )

    rng = np.random.default_rng(11)
    h, w = 18, 24
    right = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    left = np.roll(right, 2, axis=1)
    params = init_vgg16_params(seed=0)

    full = notebook_window_search(params, left, right, max_disparity=5)
    ys = [0, 5, 11, 17]
    rows = notebook_rows(params, left, right, ys, full, max_disparity=5)
    for y in ys:
        np.testing.assert_array_equal(rows[y], full[y])
