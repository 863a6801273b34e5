"""VGG-16 feature extractor in pure JAX (LPIPS backbone).

Replacement for the reference notebook's ``lpips.LPIPS
(net='vgg')`` tower (``perceptual_window_search/Perceptual_window_search
.ipynb`` cells 6-8): the five feature stages are relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3 (channels 64/128/256/512/512, strides
1/2/4/8/16), preceded by the LPIPS input scaling layer.

Weights: pretrained VGG/LPIPS weights cannot be downloaded in this
environment (zero egress). The module therefore supports
  * ``load_params_npz`` — load a converted weight file when provided
    (``save_params_npz`` writes the matching layout; a torch LPIPS state
    dict converts with ``convert_torch_lpips``);
  * ``init_vgg16_params`` — deterministic He-init fallback. Random
    convolutional features still yield a usable perceptual-ish metric
    (random-weight VGG is a known baseline for perceptual distances), and
    the full pipeline is exercised end-to-end either way.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# (out_channels, num_convs) per VGG-16 block; stage taps after each block
VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
STAGE_CHANNELS = (64, 128, 256, 512, 512)
STAGE_STRIDES = (1, 2, 4, 8, 16)

# LPIPS scaling layer constants (published with the LPIPS reference
# implementation; inputs are RGB in [-1, 1])
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def init_vgg16_params(seed: int = 0, with_lins: bool = True) -> Dict:
    """Deterministic He-initialized VGG-16 conv stack + unit lin weights."""
    rng = np.random.default_rng(seed)
    params: Dict = {"convs": [], "lins": []}
    in_ch = 3
    for out_ch, n_convs in VGG16_BLOCKS:
        block = []
        for _ in range(n_convs):
            fan_in = 3 * 3 * in_ch
            w = rng.normal(0, np.sqrt(2.0 / fan_in), (out_ch, in_ch, 3, 3))
            b = np.zeros((out_ch,))
            block.append((w.astype(np.float32), b.astype(np.float32)))
            in_ch = out_ch
        params["convs"].append(block)
    if with_lins:
        for ch in STAGE_CHANNELS:
            params["lins"].append(np.full((ch,), 1.0 / ch, np.float32))
    return params


@functools.lru_cache(maxsize=4)
def get_params(weights_path: str = "", seed: int = 0) -> Dict:
    """Load converted LPIPS weights when a path is configured, else the
    documented deterministic He-init fallback (no downloadable weights in
    this environment)."""
    if weights_path:
        return load_params_npz(weights_path)
    return init_vgg16_params(seed)


def save_params_npz(path: str, params: Dict) -> None:
    flat = {}
    for bi, block in enumerate(params["convs"]):
        for ci, (w, b) in enumerate(block):
            flat[f"conv_{bi}_{ci}_w"] = np.asarray(w)
            flat[f"conv_{bi}_{ci}_b"] = np.asarray(b)
    for li, lin in enumerate(params.get("lins", [])):
        flat[f"lin_{li}"] = np.asarray(lin)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict:
    data = np.load(path)
    params: Dict = {"convs": [], "lins": []}
    for bi, (_, n_convs) in enumerate(VGG16_BLOCKS):
        block = []
        for ci in range(n_convs):
            block.append((data[f"conv_{bi}_{ci}_w"], data[f"conv_{bi}_{ci}_b"]))
        params["convs"].append(block)
    li = 0
    while f"lin_{li}" in data:
        params["lins"].append(data[f"lin_{li}"])
        li += 1
    return params


def convert_torch_lpips(state_dict) -> Dict:
    """Convert a torch LPIPS(net='vgg') state dict (host-side, torch cpu).

    Layout: net.slice{1..5}.<idx>.weight/bias for the VGG convs and
    lins.{0..4}.model.1.weight for the 1x1 lin layers.
    """
    params: Dict = {"convs": [], "lins": []}
    # vgg16.features indices of convs per block
    conv_idx = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
    for bi, idxs in enumerate(conv_idx):
        block = []
        for idx in idxs:
            w = None
            for key_fmt in (f"net.slice{bi+1}.{idx}.weight", f"net.features.{idx}.weight"):
                if key_fmt in state_dict:
                    w = np.asarray(state_dict[key_fmt])
                    b = np.asarray(state_dict[key_fmt.replace("weight", "bias")])
                    break
            if w is None:
                raise KeyError(f"conv weight for block {bi} idx {idx} not found")
            block.append((w.astype(np.float32), b.astype(np.float32)))
        params["convs"].append(block)
    for li in range(5):
        key = f"lins.{li}.model.1.weight"
        if key in state_dict:
            params["lins"].append(
                np.asarray(state_dict[key]).reshape(-1).astype(np.float32)
            )
    return params


def _conv3x3(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x (N, C, H, W), w (O, C, 3, 3) — SAME padding + ReLU-ready output."""
    y = lax.conv_general_dilated(
        x, jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return y + jnp.asarray(b)[None, :, None, None]


def vgg16_features(params: Dict, image: jnp.ndarray) -> List[jnp.ndarray]:
    """Five LPIPS feature stages for an (H, W, 3) RGB image in [0, 255].

    Returns list of (C_s, H/2^s, W/2^s) arrays.
    """
    x = image.astype(jnp.float32) / 127.5 - 1.0          # [-1, 1]
    x = (x - _LPIPS_SHIFT) / _LPIPS_SCALE                # LPIPS scaling layer
    x = jnp.transpose(x, (2, 0, 1))[None]                # (1, 3, H, W)
    return [s[0] for s in vgg16_features_nchw(params, x)]


def vgg16_features_batched(params: Dict, images: jnp.ndarray) -> List[jnp.ndarray]:
    """Stages for a BATCH of RGB [0, 255] images/windows (N, h, w, 3).

    One batched conv stack instead of N forwards — how the notebook's
    per-window tower (cells 6-8) maps onto large batched convolutions. Returns a list of
    (N, C_s, h_s, w_s) arrays.
    """
    x = images.astype(jnp.float32) / 127.5 - 1.0
    x = (x - _LPIPS_SHIFT) / _LPIPS_SCALE
    x = jnp.transpose(x, (0, 3, 1, 2))                   # (N, 3, h, w)
    return vgg16_features_nchw(params, x)


def vgg16_features_nchw(params: Dict, x: jnp.ndarray) -> List[jnp.ndarray]:
    """Conv/pool tower on pre-scaled (N, 3, H, W) input."""
    stages = []
    for bi, block in enumerate(params["convs"]):
        for w, b in block:
            x = jax.nn.relu(_conv3x3(x, w, b))
        stages.append(x)
        if bi < len(params["convs"]) - 1:
            x = lax.reduce_window(
                x, -jnp.inf, lax.max,
                window_dimensions=(1, 1, 2, 2),
                window_strides=(1, 1, 2, 2),
                padding="VALID",
            )
    return stages


def normalize_features(feat: jnp.ndarray, eps: float = 1e-10) -> jnp.ndarray:
    """LPIPS unit-normalization over the channel axis (C, H, W)."""
    norm = jnp.sqrt(jnp.sum(feat * feat, axis=0, keepdims=True))
    return feat / (norm + eps)
