"""ORB-style binary feature detection + description (pure JAX).

Replacement for the cv::ORB / cv::BRISK frontend of the
reference's uncalibrated path (``src/rectification_main.cpp:26-63``:
ORB with 500 features, scaleFactor 1.2, 4 levels, FAST threshold 20,
Harris ranking, patch size 21). Instead of translating OpenCV's
pointer-chasing FAST, every stage is a dense, vectorized array program:

  * image pyramid (4 levels, factor 1.2) via ``jax.image.resize``;
  * FAST-16 segment test evaluated for ALL pixels at once — the 16
    Bresenham-circle samples become 16 rolled copies of the image, and
    the "9 contiguous" arc test a circular windowed sum;
  * Harris corner response (Sobel structure tensor) for ranking, exactly
    ORB's HARRIS_SCORE mode;
  * 3x3 non-max suppression + global fixed-K top-K (static shapes);
  * intensity-centroid orientation (ORB's rotation estimate);
  * rotated-BRIEF 256-bit descriptor from a fixed pseudo-random pattern,
    stored as a (K, 256) float 0/1 matrix so Hamming matching is one
    matmul (see ops/matching.py:match_descriptors_binary).

The descriptor layout ({0,1} floats rather than packed bytes) is a
deliberate choice: Hamming(a, b) = |a| + |b| - 2 a.b, which turns
brute-force matching into a single (K x K) Gram matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from stereo_reconstruction.config import BriskConfig, OrbConfig
from stereo_reconstruction.ops.features import (
    Keypoints,
    gaussian_blur,
    rgb_to_gray,
)


def _bilinear(img, sy, sx):
    """Bilinear sample of a single (H, W) plane (features._bilinear now
    operates on the flat SIFT pyramid stack; rBRIEF samples one plane)."""
    h, w = img.shape
    x0 = jnp.floor(sx); y0 = jnp.floor(sy)
    fx = sx - x0; fy = sy - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 2)
    v00 = img[y0, x0]; v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]; v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)

# FAST-16: the 16 (dy, dx) offsets of the radius-3 Bresenham circle, in
# circular order (OpenCV's ordering starts at (0, 3) going clockwise).
_FAST_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _brief_pattern(num_bits: int, patch_size: int) -> np.ndarray:
    """Fixed pseudo-random BRIEF sampling pattern: ``num_bits`` point
    pairs ~ N(0, (patch/5)^2), clipped inside the patch. Deterministic
    (seeded) so descriptors are reproducible across runs — the
    framework-wide determinism policy (SURVEY §5: no std::random_device).
    """
    rng = np.random.default_rng(0x0B1EF)
    sigma = patch_size / 5.0
    lim = patch_size / 2.0 - 1.0
    pts = rng.normal(0.0, sigma, size=(num_bits, 2, 2))
    return np.clip(pts, -lim, lim).astype(np.float32)   # (bits, pair, yx)


@functools.partial(jax.jit, static_argnames=("config",))
def detect_and_describe_orb(
    image: jnp.ndarray,                   # (H, W, 3) or (H, W), 0..255
    config: OrbConfig = OrbConfig(),
) -> Keypoints:
    gray = rgb_to_gray(image)             # keep 0..255: FAST threshold is 20 DN
    h, w = gray.shape
    K = config.max_keypoints

    per_level = []
    for level in range(config.num_levels):
        scale = config.scale_factor ** level
        lh, lw = int(round(h / scale)), int(round(w / scale))
        if lh < 2 * config.edge_margin + 8 or lw < 2 * config.edge_margin + 8:
            break
        img = gray if level == 0 else jax.image.resize(gray, (lh, lw), "linear")
        per_level.append(_level_keypoints(img, float(scale), config, K))

    if not per_level:
        raise ValueError(
            f"image {h}x{w} is smaller than one ORB level needs "
            f"(2*edge_margin+8 = {2 * config.edge_margin + 8} px per side)")

    xy = jnp.concatenate([c[0] for c in per_level])
    resp = jnp.concatenate([c[1] for c in per_level])
    ori = jnp.concatenate([c[2] for c in per_level])
    desc = jnp.concatenate([c[3] for c in per_level])
    valid = jnp.concatenate([c[4] for c in per_level])
    scl = jnp.concatenate([c[5] for c in per_level])

    score = jnp.where(valid, resp, -jnp.inf)
    top = jnp.argsort(-score)[:K]
    return Keypoints(
        xy=xy[top], scale=scl[top], response=resp[top],
        orientation=ori[top], descriptors=desc[top], valid=valid[top],
    )


def _level_keypoints(img, scale: float, config: OrbConfig, K: int):
    lh, lw = img.shape
    t = float(config.fast_threshold)

    # --- FAST-16 segment test, all pixels at once -----------------------
    shifted = jnp.stack(
        [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for dy, dx in _FAST_OFFSETS]
    )                                                    # (16, lh, lw)
    brighter = shifted > img[None] + t
    darker = shifted < img[None] - t
    is_corner = _arc_test(brighter, config.fast_arc) | _arc_test(darker, config.fast_arc)

    # --- Harris response for ranking (ORB::HARRIS_SCORE) ----------------
    gx = (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1)) / 2.0
    gy = (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0)) / 2.0
    sxx = gaussian_blur(gx * gx, 1.5)
    syy = gaussian_blur(gy * gy, 1.5)
    sxy = gaussian_blur(gx * gy, 1.5)
    harris = (sxx * syy - sxy * sxy) - config.harris_k * (sxx + syy) ** 2

    # --- mask: corners only, inside the margin, 3x3 non-max -------------
    m = config.edge_margin
    ys, xs = jnp.arange(lh), jnp.arange(lw)
    interior = (
        (ys[:, None] >= m) & (ys[:, None] < lh - m)
        & (xs[None, :] >= m) & (xs[None, :] < lw - m)
    )
    resp = jnp.where(is_corner & interior, harris, -jnp.inf)
    local_max = lax.reduce_window(
        resp, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME"
    )
    resp = jnp.where((resp == local_max) & jnp.isfinite(resp), resp, -jnp.inf)

    flat = resp.reshape(-1)
    top = jnp.argsort(-flat)[:K]
    valid = jnp.isfinite(flat[top]) & (flat[top] > 0)
    yi, xi = jnp.unravel_index(top, resp.shape)

    # --- intensity-centroid orientation (patch radius = patch//2) -------
    ori = _intensity_centroid(img, yi, xi, config.patch_size)

    # --- rotated BRIEF on the smoothed image -----------------------------
    smooth = gaussian_blur(img, 2.0)
    pattern = jnp.asarray(_brief_pattern(config.num_bits, config.patch_size))
    desc = _rbrief(smooth, yi, xi, ori, pattern)

    xy = jnp.stack([xi.astype(jnp.float32) * scale,
                    yi.astype(jnp.float32) * scale], axis=-1)
    scl = jnp.full((K,), scale, jnp.float32)
    return xy, flat[top], ori, desc, valid, scl


# ---------------------------------------------------------------------------
# BRISK-style frontend (reference rectification_main.cpp:46-51:
# cv::BRISK::create(30, 3, 1.0f)). Same dense array-program stance as the
# ORB path above: FAST runs on every pixel of every scale-space layer at
# once; the descriptor's 60 ring samples are bilinear gathers from a
# 5-plane Gaussian blur stack (one blur per ring sigma) — no per-keypoint
# image patches, no data-dependent shapes.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _brisk_pattern(pattern_scale: float, max_bits: int):
    """The BRISK sampling pattern (Leutenegger et al. 2011, Fig. 4, as
    parameterized by cv::BRISK): 60 points on concentric rings
    radii = 0.85*patternScale*{0, 2.9, 4.9, 7.4, 10.8} with
    {1, 10, 14, 15, 20} points; per-point Gaussian sigma proportional to
    the in-ring point spacing; short pairs (dist < 5.85*patternScale)
    form the descriptor bits, long pairs (dist > 8.2*patternScale) vote
    the orientation.

    Returns numpy constants (pattern is static; baked into the jit):
      pts (60, 2) [y, x], ring (60,) int, ring_sigmas (5,),
      short (S, 2) index pairs, long (L, 2) index pairs,
      long_dir (L, 2) [y, x] factors (p_j - p_i) / |p_j - p_i|^2 — norm
      1/d, so a dot with the smoothed-intensity gradient pair gives the
      paper's distance-normalized orientation vote directly.
    """
    f = 0.85 * pattern_scale
    radii = np.array([0.0, 2.9, 4.9, 7.4, 10.8], np.float64) * f
    counts = [1, 10, 14, 15, 20]
    pts, ring = [], []
    ring_sigmas = []
    for ri, (r, n) in enumerate(zip(radii, counts)):
        sigma = 0.5 if r == 0.0 else max(0.5, r * np.sin(np.pi / n))
        ring_sigmas.append(sigma)
        for k in range(n):
            th = 2.0 * np.pi * k / n + (np.pi / n if ri % 2 else 0.0)
            pts.append((r * np.sin(th), r * np.cos(th)))
            ring.append(ri)
    pts = np.asarray(pts, np.float32)                     # (60, 2) [y, x]
    ring = np.asarray(ring, np.int32)

    ii, jj = np.triu_indices(len(pts), 1)
    d = pts[jj] - pts[ii]                                 # (P, 2)
    dist = np.linalg.norm(d, axis=1)
    d_max = 5.85 * pattern_scale                          # short-pair cutoff
    d_min = 8.2 * pattern_scale                           # long-pair cutoff
    short_sel = np.flatnonzero(dist < d_max)
    short_sel = short_sel[np.argsort(dist[short_sel], kind="stable")][:max_bits]
    long_sel = np.flatnonzero(dist > d_min)
    short = np.stack([ii[short_sel], jj[short_sel]], 1).astype(np.int32)
    long_ = np.stack([ii[long_sel], jj[long_sel]], 1).astype(np.int32)
    long_dir = (d[long_sel] / (dist[long_sel, None] ** 2)).astype(np.float32)
    return pts, ring, np.asarray(ring_sigmas, np.float32), short, long_, long_dir


def _fast_score(diff: jnp.ndarray, arc: int) -> jnp.ndarray:
    """FAST saliency: the largest threshold t at which the segment test
    still fires = max over the 16 circular arc windows of the windowed
    MIN of (brighter: s - p, darker: p - s). ``diff`` is (16, H, W)."""
    scores = []
    for sign in (1.0, -1.0):
        b = jnp.concatenate([sign * diff, sign * diff[: arc - 1]], axis=0)
        mins = [
            jnp.min(lax.dynamic_slice_in_dim(b, s, arc, 0), axis=0)
            for s in range(diff.shape[0])
        ]
        scores.append(jnp.max(jnp.stack(mins), axis=0))
    return jnp.maximum(scores[0], scores[1])


def _bilinear_planes(stack, plane, sy, sx):
    """Bilinear sample of (P, H, W) ``stack`` where each sample point i
    reads plane ``plane[i]`` (static int array baked per pattern)."""
    _, h, w = stack.shape
    x0 = jnp.floor(sx); y0 = jnp.floor(sy)
    fx = sx - x0; fy = sy - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 2)
    v00 = stack[plane, y0, x0]; v01 = stack[plane, y0, x0 + 1]
    v10 = stack[plane, y0 + 1, x0]; v11 = stack[plane, y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


@functools.partial(jax.jit, static_argnames=("config",))
def detect_and_describe_brisk(
    image: jnp.ndarray,                   # (H, W, 3) or (H, W), 0..255
    config: BriskConfig = BriskConfig(),
) -> Keypoints:
    gray = rgb_to_gray(image)
    h, w = gray.shape
    K = config.max_keypoints
    pattern = _brisk_pattern(float(config.pattern_scale), int(config.max_bits))

    # octave/intra-octave ladder: scales 2^i and 1.5 * 2^i
    scales = []
    for i in range(config.octaves):
        scales += [2.0 ** i, 1.5 * 2.0 ** i]
    per_level = []
    for scale in scales:
        lh, lw = int(round(h / scale)), int(round(w / scale))
        if lh < 2 * config.edge_margin + 8 or lw < 2 * config.edge_margin + 8:
            break
        img = gray if scale == 1.0 else jax.image.resize(gray, (lh, lw), "linear")
        per_level.append(_brisk_level(img, float(scale), config, K, pattern))

    if not per_level:
        raise ValueError(
            f"image {h}x{w} is smaller than one BRISK level needs "
            f"(2*edge_margin+8 = {2 * config.edge_margin + 8} px per side)")

    xy = jnp.concatenate([c[0] for c in per_level])
    resp = jnp.concatenate([c[1] for c in per_level])
    ori = jnp.concatenate([c[2] for c in per_level])
    desc = jnp.concatenate([c[3] for c in per_level])
    valid = jnp.concatenate([c[4] for c in per_level])
    scl = jnp.concatenate([c[5] for c in per_level])

    score = jnp.where(valid, resp, -jnp.inf)
    top = jnp.argsort(-score)[:K]
    return Keypoints(
        xy=xy[top], scale=scl[top], response=resp[top],
        orientation=ori[top], descriptors=desc[top], valid=valid[top],
    )


def _brisk_level(img, scale: float, config: BriskConfig, K: int, pattern):
    pts, ring, ring_sigmas, short, long_, long_dir = pattern
    lh, lw = img.shape

    # --- FAST-16 with saliency = max surviving threshold ----------------
    shifted = jnp.stack(
        [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for dy, dx in _FAST_OFFSETS]
    )
    saliency = _fast_score(shifted - img[None], config.fast_arc)

    m = config.edge_margin
    ys, xs = jnp.arange(lh), jnp.arange(lw)
    interior = (
        (ys[:, None] >= m) & (ys[:, None] < lh - m)
        & (xs[None, :] >= m) & (xs[None, :] < lw - m)
    )
    resp = jnp.where(interior & (saliency > config.threshold), saliency, -jnp.inf)
    local_max = lax.reduce_window(
        resp, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME"
    )
    resp = jnp.where((resp == local_max) & jnp.isfinite(resp), resp, -jnp.inf)

    flat = resp.reshape(-1)
    top = jnp.argsort(-flat)[:K]
    valid = jnp.isfinite(flat[top])
    yi, xi = jnp.unravel_index(top, resp.shape)

    # --- per-ring Gaussian blur stack (descriptor smoothing) ------------
    blurs = jnp.stack([gaussian_blur(img, float(s)) for s in ring_sigmas])
    plane = jnp.asarray(ring)
    py, px = jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])
    li, lj = jnp.asarray(long_[:, 0]), jnp.asarray(long_[:, 1])
    gdir = jnp.asarray(long_dir)                          # (L, 2) [y, x]/d^2
    si, sj = jnp.asarray(short[:, 0]), jnp.asarray(short[:, 1])

    def one(y, x):
        yf = y.astype(jnp.float32); xf = x.astype(jnp.float32)
        v0 = _bilinear_planes(
            blurs, plane,
            jnp.clip(yf + py, 0.0, lh - 2.0), jnp.clip(xf + px, 0.0, lw - 2.0),
        )
        # orientation: g = mean over long pairs of (I_j - I_i) (p_j - p_i)/d^2
        dv = v0[lj] - v0[li]                              # (L,)
        g = jnp.mean(dv[:, None] * gdir, axis=0)          # (2,) [gy, gx]
        theta = jnp.arctan2(g[0], g[1])
        # rotate the pattern by theta, resample, compare short pairs
        ct, st = jnp.cos(theta), jnp.sin(theta)
        ry = st * px + ct * py
        rx = ct * px - st * py
        v1 = _bilinear_planes(
            blurs, plane,
            jnp.clip(yf + ry, 0.0, lh - 2.0), jnp.clip(xf + rx, 0.0, lw - 2.0),
        )
        bits = (v1[sj] > v1[si]).astype(jnp.float32)      # (S,)
        return theta, bits

    ori, desc = jax.vmap(one)(yi, xi)

    xy = jnp.stack([xi.astype(jnp.float32) * scale,
                    yi.astype(jnp.float32) * scale], axis=-1)
    scl = jnp.full((K,), scale, jnp.float32)
    return xy, flat[top], ori, desc, valid, scl


def _arc_test(bits: jnp.ndarray, arc: int) -> jnp.ndarray:
    """True where >= ``arc`` CONTIGUOUS circle samples (circularly) are
    set. Windowed sums over the doubled bit stack — no per-pixel loops."""
    b = jnp.concatenate([bits, bits[: arc - 1]], axis=0).astype(jnp.float32)
    csum = jnp.cumsum(b, axis=0)
    zero = jnp.zeros_like(csum[:1])
    csum = jnp.concatenate([zero, csum], axis=0)        # (16+arc, lh, lw)
    win = csum[arc:] - csum[:-arc]                      # windowed sums len=arc
    return jnp.max(win, axis=0) >= arc


def _intensity_centroid(img, yi, xi, patch_size: int):
    """ORB orientation: theta = atan2(m01, m10) over a circular patch."""
    r = patch_size // 2
    lh, lw = img.shape
    ys = jnp.clip(yi, r, lh - r - 1)
    xs = jnp.clip(xi, r, lw - r - 1)
    dy = jnp.arange(-r, r + 1, dtype=jnp.float32)[:, None]
    dx = jnp.arange(-r, r + 1, dtype=jnp.float32)[None, :]
    circ = (dy * dy + dx * dx) <= r * r

    def one(y, x):
        p = lax.dynamic_slice(img, (y - r, x - r), (2 * r + 1, 2 * r + 1))
        p = jnp.where(circ, p, 0.0)
        m10 = jnp.sum(p * dx)
        m01 = jnp.sum(p * dy)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(ys, xs)


def _rbrief(img, yi, xi, ori, pattern):
    """Rotated BRIEF: bit = I(R(theta) p1) < I(R(theta) p2), bilinear."""
    lh, lw = img.shape

    def one(y, x, theta):
        ct, st = jnp.cos(theta), jnp.sin(theta)
        py, px = pattern[..., 0], pattern[..., 1]       # (bits, 2)
        ry = st * px + ct * py
        rx = ct * px - st * py
        sy = jnp.clip(y.astype(jnp.float32) + ry, 0.0, lh - 2.0)
        sx = jnp.clip(x.astype(jnp.float32) + rx, 0.0, lw - 2.0)
        v = _bilinear(img, sy, sx)                      # (bits, 2)
        return (v[:, 0] < v[:, 1]).astype(jnp.float32)

    return jax.vmap(one)(yi, xi, ori)
