"""DoG/SIFT-style feature detection + description (pure JAX).

Replacement for the reference's OpenCV SIFT frontend
(``src/PoseEstimation/keypoints.cpp:27-32``: cv::SIFT with max 500
keypoints, contrastThreshold 0.01, edgeThreshold 5). Everything is
static-shaped and jittable:

  * Gaussian scale-space pyramid (separable convolutions), DoG planes;
  * 3x3x3 scale-space extrema with contrast + edge (Hessian-ratio)
    rejection, exactly the two thresholds the reference exposes;
  * fixed-size top-K keypoint selection by |response| with a validity
    mask (no dynamic shapes — unused slots carry weight 0);
  * gradient-orientation assignment (36-bin histogram) and a 4x4x8
    SIFT-like descriptor sampled on a rotated grid, L2-normalized with
    the standard 0.2 clip + renormalize.

This is a re-design, not a Lowe-exact clone: no initial 2x upsampling and
single dominant orientation per keypoint (documented deviations; the
pose pipeline's BA refines away small localization differences).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from stereo_reconstruction.config import FrontendConfig


class Keypoints(NamedTuple):
    xy: jnp.ndarray          # (K, 2) pixel coords (x, y) in original image
    scale: jnp.ndarray       # (K,) sigma of the detection scale
    response: jnp.ndarray    # (K,) |DoG| response
    orientation: jnp.ndarray  # (K,) radians
    descriptors: jnp.ndarray  # (K, 128) L2-normalized
    valid: jnp.ndarray       # (K,) bool


def rgb_to_gray(image: jnp.ndarray) -> jnp.ndarray:
    """BT.601 luma, matching cv::cvtColor BGR2GRAY weights on RGB input."""
    image = image.astype(jnp.float32)
    if image.ndim == 2:
        return image
    return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]


@functools.lru_cache(maxsize=256)
def _blur_matrix(n: int, sigma: float):
    """(n, n) banded-Toeplitz blur operator: row i holds the discrete
    Gaussian taps for output i with reflect (BORDER_REFLECT_101) folding
    at the edges. Built on host once per (length, sigma); baked into the
    trace as a constant."""
    import numpy as np

    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    B = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for t in range(-radius, radius + 1):
        j = i + t
        j = np.where(j < 0, -j, j)
        j = np.where(j >= n, 2 * n - 2 - j, j)
        np.add.at(B, (i, j), k[t + radius])
    return B


def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with reflect padding, (H, W) float32.

    Lowered as two banded-Toeplitz MATMULS (B_v @ img @ B_h^T) instead of
    1-D convolutions: the SIFT pyramid runs 24 tiny (1,1,H,W)-shaped
    blurs, and the same math as (H,H)/(W,W) matmuls batches into a few
    large products. The matrices encode the identical discrete
    kernel + reflect-101 folding, so results match the conv formulation
    to f32 dot-order."""
    h, w = img.shape
    Bv = jnp.asarray(_blur_matrix(h, float(sigma)))
    Bh = jnp.asarray(_blur_matrix(w, float(sigma)))
    return (Bv @ img) @ Bh.T


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    return img[::2, ::2]


@functools.partial(jax.jit, static_argnames=("config",))
def detect_and_describe(
    image: jnp.ndarray,                    # (H, W, 3) or (H, W)
    config: FrontendConfig = FrontendConfig(),
) -> Keypoints:
    det = _detect(image, config)
    return _describe(det, config)


def _build_pyramid(gray, config: FrontendConfig):
    """Gaussian scale-space + DoG planes per octave: list of
    (G (s+3, oh, ow), dog (s+2, oh, ow), sigmas)."""
    s = config.scales_per_octave
    sig0 = config.init_sigma
    out = []
    octave_img = gaussian_blur(gray, sig0)
    for _octave in range(config.num_octaves):
        oh, ow = octave_img.shape
        # the orientation stage reads a 17x17 patch (R=8) — octaves
        # smaller than that cannot host a keypoint
        if oh < 17 or ow < 17:
            break
        sigmas = [sig0 * (2.0 ** (i / s)) for i in range(s + 3)]
        gauss = [octave_img]
        for i in range(1, s + 3):
            # incremental blur: sigma_delta^2 = sig_i^2 - sig_{i-1}^2
            delta = float((sigmas[i] ** 2 - sigmas[i - 1] ** 2) ** 0.5)
            gauss.append(gaussian_blur(gauss[-1], delta))
        G = jnp.stack(gauss)                          # (s+3, oh, ow)
        out.append((G, G[1:] - G[:-1], sigmas))
        octave_img = _downsample2(G[s])               # seed next octave
    return out


def _detect(image, config: FrontendConfig):
    """Pyramid + per-octave extrema + global top-K (no ori/desc).

    Returns the winner indices plus the flat padded gradient pyramid the
    describe stage gathers from (kept separate so the profiler can time
    detection and description independently)."""
    gray = rgb_to_gray(image) / 255.0
    K = config.max_keypoints
    s = config.scales_per_octave
    sig0 = config.init_sigma

    # Detection runs per octave (top-K candidates each); orientation and
    # descriptors run ONCE on the K global winners (not num_octaves*K
    # candidates) — the per-keypoint gathers are the expensive part of
    # the frontend, so describing losers is pure waste. The per-octave
    # gradient pyramids are zero-padded to the octave-0 shape and stacked
    # flat as (n_oct*s, H0, W0) so the winner gathers index one array.
    per_oct = []
    mags, angs, shapes = [], [], []
    pyr = _build_pyramid(gray, config)
    h0, w0 = pyr[0][0].shape[1:]
    for octave, (G, dog, sigmas) in enumerate(pyr):
        oh, ow = G.shape[1:]
        cands = _octave_candidates(dog, sigmas, octave, config, K)
        per_oct.append(cands)

        # gradients of the matching gaussian planes for ori/descriptor
        Gsel = G[1:-2]                                # planes of `center`
        gx = (jnp.roll(Gsel, -1, 2) - jnp.roll(Gsel, 1, 2)) / 2.0
        gy = (jnp.roll(Gsel, -1, 1) - jnp.roll(Gsel, 1, 1)) / 2.0
        pad = [(0, 0), (0, h0 - oh), (0, w0 - ow)]
        mags.append(jnp.pad(jnp.sqrt(gx * gx + gy * gy), pad))
        angs.append(jnp.pad(jnp.arctan2(gy, gx), pad))
        shapes.append((oh, ow))

    # merge octaves: concatenate candidate lists, take global top-K
    xy = jnp.concatenate([c[0] for c in per_oct])
    scale = jnp.concatenate([c[1] for c in per_oct])
    resp = jnp.concatenate([c[2] for c in per_oct])
    valid = jnp.concatenate([c[3] for c in per_oct])
    si = jnp.concatenate([c[4] for c in per_oct])
    yi = jnp.concatenate([c[5] for c in per_oct])
    xi = jnp.concatenate([c[6] for c in per_oct])
    oi = jnp.concatenate([
        jnp.full(c[0].shape[0], o, jnp.int32) for o, c in enumerate(per_oct)
    ])

    score = jnp.where(valid, resp, -jnp.inf)
    # top-K selection, not a full sort: same result (descending value,
    # ties by ascending index — lax.top_k matches stable argsort here)
    # at a fraction of the cost of sorting all octave candidates
    _, top = lax.top_k(score, K)

    mag = jnp.concatenate(mags)                       # (n_oct*s, H0, W0)
    ang = jnp.concatenate(angs)
    oh_arr = jnp.asarray([sh[0] for sh in shapes], jnp.int32)
    ow_arr = jnp.asarray([sh[1] for sh in shapes], jnp.int32)
    sigs = jnp.asarray(
        [sig0 * (2.0 ** (i / s)) for i in range(1, s + 1)], jnp.float32)

    oi_w, si_w, yi_w, xi_w = oi[top], si[top], yi[top], xi[top]
    plane = oi_w * s + si_w                           # flat pyramid index
    return {
        "xy": xy[top], "scale": scale[top], "response": resp[top],
        "valid": valid[top], "plane": plane, "si": si_w, "yi": yi_w,
        "xi": xi_w, "mag": mag, "ang": ang, "sigs": sigs,
        "oh": oh_arr[oi_w], "ow": ow_arr[oi_w],
    }


def _describe(det, config: FrontendConfig) -> Keypoints:
    """Orientation + descriptor for the K global winners of _detect.

    Gather strategy: instead of one scalar gather per patch sample, ONE
    row-block gather per keypoint pulls a (U, W0) band of full pyramid
    rows (a row gather is a contiguous embedding-style lookup), and
    every sample —
    integer patch reads, rotated bilinear taps, nearest angle reads —
    becomes a one-hot/bilinear-weight contraction against that band
    (matrix products). Weights are built in ABSOLUTE image coordinates, so rows
    clamped at plane borders (whose content is wrong) always carry zero
    weight, reproducing the old per-sample clip semantics exactly.
    """
    mag, ang, sigs = det["mag"], det["ang"], det["sigs"]
    plane, si, yi, xi = det["plane"], det["si"], det["yi"], det["xi"]
    oh, ow = det["oh"], det["ow"]
    Pn, H0, W0 = mag.shape

    # static row budget: descriptor samples reach 0.75*sigma_max * the
    # rotated grid half-diagonal; +2 covers the bilinear/nearest taps
    sig_max = config.init_sigma * 2.0          # sigs[-1] = sig0 * 2^(s/s)
    r_super = int(np.ceil(0.75 * sig_max * (_GRID - 1) / 2 * np.sqrt(2.0))) + 2
    r_super = max(r_super, _R_ORI)
    U = 2 * r_super + 1

    rows_abs = (yi - r_super)[:, None] + jnp.arange(U)[None, :]  # (K, U)
    fr = plane[:, None] * H0 + jnp.clip(rows_abs, 0, H0 - 1)
    rows_m = jnp.take(mag.reshape(Pn * H0, W0), fr, axis=0)      # (K, U, W0)
    rows_a = jnp.take(ang.reshape(Pn * H0, W0), fr, axis=0)

    ori = _orientation(rows_m, rows_a, rows_abs, si, yi, xi, sigs, oh, ow)
    desc = _descriptor(rows_m, rows_a, rows_abs, si, yi, xi, sigs, ori,
                       oh, ow)
    return Keypoints(
        xy=det["xy"],
        scale=det["scale"],
        response=det["response"],
        orientation=ori,
        descriptors=desc,
        valid=det["valid"],
    )


def _octave_candidates(dog, sigmas, octave, config: FrontendConfig, K: int):
    """Top-K scale-space extrema of one octave (detection only; the
    winners' orientations/descriptors are computed after the global
    cross-octave merge)."""
    ns, oh, ow = dog.shape
    stride = 2.0 ** octave

    # 3x3x3 local extremum test on interior planes
    center = dog[1:-1]
    neigh_max = jnp.full_like(center, -jnp.inf)
    neigh_min = jnp.full_like(center, jnp.inf)
    for ds in (-1, 0, 1):
        plane = dog[1 + ds : ns - 1 + ds]
        for dy in (-1, 0, 1):
            py = jnp.roll(plane, -dy, axis=1)
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                p = jnp.roll(py, -dx, axis=2)
                neigh_max = jnp.maximum(neigh_max, p)
                neigh_min = jnp.minimum(neigh_min, p)
    is_max = center > neigh_max
    is_min = center < neigh_min

    contrast_ok = jnp.abs(center) > (config.contrast_threshold / config.scales_per_octave)

    # edge rejection: 2x2 spatial Hessian ratio (reference edgeThreshold=5)
    dxx = jnp.roll(center, -1, 2) - 2 * center + jnp.roll(center, 1, 2)
    dyy = jnp.roll(center, -1, 1) - 2 * center + jnp.roll(center, 1, 1)
    dxy = (
        jnp.roll(jnp.roll(center, -1, 1), -1, 2)
        - jnp.roll(jnp.roll(center, -1, 1), 1, 2)
        - jnp.roll(jnp.roll(center, 1, 1), -1, 2)
        + jnp.roll(jnp.roll(center, 1, 1), 1, 2)
    ) / 4.0
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = config.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    # border margin
    ys = jnp.arange(oh)
    xs = jnp.arange(ow)
    margin = 8
    border_ok = (
        (ys[:, None] >= margin) & (ys[:, None] < oh - margin)
        & (xs[None, :] >= margin) & (xs[None, :] < ow - margin)
    )[None]

    good = (is_max | is_min) & contrast_ok & edge_ok & border_ok
    response = jnp.where(good, jnp.abs(center), 0.0)

    flat = response.reshape(-1)
    # top-K of ~500k candidates: lax.top_k instead of a full argsort (the
    # sort dominated the SIFT stage; identical selection incl. tie order)
    top_vals, top = lax.top_k(flat, K)
    valid = top_vals > 0
    si, yi, xi = jnp.unravel_index(top, response.shape)

    # quadratic sub-pixel refinement in x and y
    def subpix(grid, idx_s, idx_y, idx_x, axis):
        c = grid[idx_s, idx_y, idx_x]
        if axis == 1:
            p = grid[idx_s, jnp.clip(idx_y + 1, 0, oh - 1), idx_x]
            m = grid[idx_s, jnp.clip(idx_y - 1, 0, oh - 1), idx_x]
        else:
            p = grid[idx_s, idx_y, jnp.clip(idx_x + 1, 0, ow - 1)]
            m = grid[idx_s, idx_y, jnp.clip(idx_x - 1, 0, ow - 1)]
        denom = p - 2 * c + m
        off = jnp.where(jnp.abs(denom) > 1e-8, -0.5 * (p - m) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    off_y = subpix(center, si, yi, xi, axis=1)
    off_x = subpix(center, si, yi, xi, axis=2)

    sigs = jnp.asarray(sigmas[1 : 1 + center.shape[0]], jnp.float32)
    kp_sigma = sigs[si] * stride
    kp_x = (xi.astype(jnp.float32) + off_x) * stride
    kp_y = (yi.astype(jnp.float32) + off_y) * stride

    xy = jnp.stack([kp_x, kp_y], axis=-1)
    return (xy, kp_sigma, flat[top], valid,
            si.astype(jnp.int32), yi.astype(jnp.int32), xi.astype(jnp.int32))


_R_ORI = 8      # orientation patch radius (17x17)
_GRID = 16      # descriptor sample grid (16x16 -> 4x4 cells x 8 bins)

# One-hot/bilinear selection contractions run at HIGH matmul precision:
# a 0/1 (or {1-f, f}) selector times a bf16x3-split f32 operand
# reconstructs the selected f32 values essentially exactly as matmuls,
# where the surrounding pose program's "highest" default would pay 6
# passes for the same answer.
_SEL_PREC = lax.Precision.HIGH


def _row_block_select(rows, wy, wx):
    """samples[k, s] = sum_{u, w} rows[k, u, w] * wy[k, s, u] * wx[k, s, w]
    — separable weighted sampling of a per-keypoint row band as matmuls."""
    A = jnp.einsum("kuw,ksw->ksu", rows, wx, precision=_SEL_PREC)
    return jnp.einsum("ksu,ksu->ks", A, wy, precision=_SEL_PREC)


def _orientation(rows_m, rows_a, rows_abs, si, yi, xi, sigs, oh, ow):
    """Dominant gradient orientation: 36-bin histogram over a Gaussian-
    weighted 17x17 patch, batched over keypoints.

    ``rows_m``/``rows_a`` are the per-keypoint (U, W0) pyramid row bands
    (see _describe); ``rows_abs`` their absolute row ids. Patch reads are
    integer one-hot selections in absolute coordinates."""
    R = _R_ORI
    K, U, W0 = rows_m.shape
    ys = jnp.clip(yi, R, oh - R - 1)
    xs = jnp.clip(xi, R, ow - R - 1)
    dd = jnp.arange(-R, R + 1)

    tgt_y = ys[:, None] + dd[None, :]                       # (K, 17)
    tgt_x = xs[:, None] + dd[None, :]
    wy = (rows_abs[:, None, :] == tgt_y[:, :, None]).astype(jnp.float32)
    wx = (jnp.arange(W0)[None, None, :]
          == tgt_x[:, :, None]).astype(jnp.float32)         # (K, 17, W0)

    # (K, 17y, 17x) patches: contract lanes then rows
    Am = jnp.einsum("kuw,kew->kue", rows_m, wx, precision=_SEL_PREC)
    m = jnp.einsum("kdu,kue->kde", wy, Am, precision=_SEL_PREC)
    Aa = jnp.einsum("kuw,kew->kue", rows_a, wx, precision=_SEL_PREC)
    a = jnp.einsum("kdu,kue->kde", wy, Aa, precision=_SEL_PREC)

    dy = dd.astype(jnp.float32)[:, None]
    dx = dd.astype(jnp.float32)[None, :]
    wgt = jnp.exp(-(dy * dy + dx * dx)[None]
                  / (2 * (1.5 * sigs[si]) ** 2)[:, None, None])
    bins = jnp.floor((a + jnp.pi) / (2 * jnp.pi) * 36).astype(jnp.int32) % 36
    # histogram as a one-hot contraction, not a scatter-add: one batched
    # matmul with no write conflicts
    onehot = (bins.reshape(K, -1)[..., None]
              == jnp.arange(36)).astype(jnp.float32)
    hist = jnp.einsum("kp,kpb->kb", (m * wgt).reshape(K, -1), onehot,
                      precision=_SEL_PREC)
    # smooth the circular histogram
    hist = (jnp.roll(hist, 1, axis=-1) + hist
            + jnp.roll(hist, -1, axis=-1)) / 3.0
    b = jnp.argmax(hist, axis=-1)
    return (b.astype(jnp.float32) + 0.5) / 36.0 * 2 * jnp.pi - jnp.pi


def _descriptor(rows_m, rows_a, rows_abs, si, yi, xi, sigs, ori, oh, ow):
    """4x4 spatial x 8 orientation SIFT-like descriptor from a rotated
    16x16 sample grid (spacing ~ sigma), batched over keypoints against
    the per-keypoint row bands (see _describe).

    Bilinear magnitude taps and nearest angle taps are separable in
    (y, x), so both become weight contractions; the weights reproduce
    _bilinear's clip semantics (x0 = clip(floor(sx), 0, w-2) with the
    UNCLIPPED fraction) in absolute coordinates."""
    GRID = _GRID
    K, U, W0 = rows_m.shape
    spacing = 0.75 * sigs[si]                               # (K,)
    g = jnp.arange(GRID, dtype=jnp.float32) - (GRID - 1) / 2
    gy2, gx2 = jnp.meshgrid(g, g, indexing="ij")
    gy = gy2.reshape(-1)[None, :] * spacing[:, None]        # (K, 256)
    gx = gx2.reshape(-1)[None, :] * spacing[:, None]
    ct = jnp.cos(ori)[:, None]
    st = jnp.sin(ori)[:, None]
    sx = xi.astype(jnp.float32)[:, None] + ct * gx - st * gy
    sy = yi.astype(jnp.float32)[:, None] + st * gx + ct * gy

    lanes = jnp.arange(W0)[None, None, :]
    h1 = (oh - 2)[:, None]
    w1 = (ow - 2)[:, None]

    # bilinear weights (absolute coords, _bilinear-exact clip semantics)
    x0f = jnp.floor(sx)
    fx = (sx - x0f)[..., None]
    x0 = jnp.clip(x0f, 0, w1).astype(jnp.int32)[..., None]
    wx_bil = ((lanes == x0) * (1 - fx) + (lanes == x0 + 1) * fx)
    y0f = jnp.floor(sy)
    fy = (sy - y0f)[..., None]
    y0 = jnp.clip(y0f, 0, h1).astype(jnp.int32)[..., None]
    ua = rows_abs[:, None, :]                               # (K, 1, U)
    wy_bil = ((ua == y0) * (1 - fy) + (ua == y0 + 1) * fy)
    m = _row_block_select(rows_m, wy_bil, wx_bil)           # (K, 256)

    # nearest-neighbor angle taps
    xn = jnp.clip(jnp.round(sx), 0, (ow - 1)[:, None]).astype(jnp.int32)
    yn = jnp.clip(jnp.round(sy), 0, (oh - 1)[:, None]).astype(jnp.int32)
    wx_nn = (lanes == xn[..., None]).astype(jnp.float32)
    wy_nn = (ua == yn[..., None]).astype(jnp.float32)
    a = _row_block_select(rows_a, wy_nn, wx_nn) - ori[:, None]

    # Gaussian weight over the window
    sig_w = GRID * spacing / 2.0                            # (K,)
    wgt = jnp.exp(-(gx * gx + gy * gy) / (2 * sig_w * sig_w)[:, None])
    mw = m * wgt                                            # (K, 256)

    # spatial bins: 4x4 blocks of the 16x16 grid
    cell = GRID // 4
    spatial = (
        (jnp.arange(GRID) // cell)[:, None] * 4
        + (jnp.arange(GRID) // cell)[None, :]
    ).reshape(-1)                                           # (256,) in [0,16)
    obin = jnp.floor((a + jnp.pi) / (2 * jnp.pi) * 8).astype(jnp.int32) % 8
    idx = spatial[None, :] * 8 + obin                       # (K, 256)
    # scatter-free binning (see _orientation): one-hot matmul
    onehot = (idx[..., None] == jnp.arange(128)).astype(jnp.float32)
    d = jnp.einsum("ks,ksb->kb", mw, onehot, precision=_SEL_PREC)

    d = d / jnp.maximum(
        jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    d = jnp.minimum(d, 0.2)
    return d / jnp.maximum(
        jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)


def _bilinear(img3, p, sy, sx, h, w):
    """Bilinear sample of plane ``p`` of a (P, H0, W0) stack; ``h``/``w``
    bound the valid (unpadded) region of that plane."""
    x0 = jnp.floor(sx); y0 = jnp.floor(sy)
    fx = sx - x0; fy = sy - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 2)
    v00 = img3[p, y0, x0]; v01 = img3[p, y0, x0 + 1]
    v10 = img3[p, y0 + 1, x0]; v11 = img3[p, y0 + 1, x0 + 1]
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def _nearest_angle(img3, p, sy, sx, h, w):
    """Nearest sampling for angles (interpolating angles across the wrap
    is wrong; NN is standard practice here)."""
    x = jnp.clip(jnp.round(sx).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(sy).astype(jnp.int32), 0, h - 1)
    return img3[p, y, x]
