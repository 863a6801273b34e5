"""Perspective warps (device-side, jittable).

Equivalent of the reference's ``cv::warpPerspective`` calls
(rectification.cpp:486-493 for images, :71-87 with INTER_NEAREST for the
disparity back-warp): inverse mapping — every destination pixel is
projected through H^{-1} into the source image and sampled bilinearly (or
nearest), constant zero border.

The destination canvas is a *static* shape (jit-friendly); the reference's
data-dependent canvases (rectification.cpp:437-484) become a padded canvas
budget chosen on host (see rectify/rectifier.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("out_shape", "method"))
def warp_perspective(
    image: jnp.ndarray,          # (H, W) or (H, W, C)
    H: jnp.ndarray,              # (3, 3) maps SOURCE coords -> DEST coords
    out_shape: Tuple[int, int],
    method: str = "bilinear",
) -> jnp.ndarray:
    """Warp ``image`` by homography ``H`` into a (out_shape) canvas.

    Matches cv::warpPerspective(src, dst, H, size) semantics: dst(p) =
    src(H^{-1} p), zero outside the source.
    """
    Hinv = jnp.linalg.inv(H.astype(jnp.float32))
    return warp_inverse_map(image, Hinv, out_shape, method)


@functools.partial(jax.jit, static_argnames=("out_shape", "method"))
def warp_inverse_map(
    image: jnp.ndarray,
    Hinv: jnp.ndarray,           # (3, 3) maps DEST coords -> SOURCE coords
    out_shape: Tuple[int, int],
    method: str = "bilinear",
) -> jnp.ndarray:
    h_out, w_out = out_shape
    h, w = image.shape[:2]
    squeeze = image.ndim == 2
    img = image[..., None] if squeeze else image
    img = img.astype(jnp.float32)

    ys = jnp.arange(h_out, dtype=jnp.float32)
    xs = jnp.arange(w_out, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)                        # (h_out, w_out)
    denom = Hinv[2, 0] * gx + Hinv[2, 1] * gy + Hinv[2, 2]
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    sx = (Hinv[0, 0] * gx + Hinv[0, 1] * gy + Hinv[0, 2]) / denom
    sy = (Hinv[1, 0] * gx + Hinv[1, 1] * gy + Hinv[1, 2]) / denom

    if method == "nearest":
        ix = jnp.round(sx).astype(jnp.int32)
        iy = jnp.round(sy).astype(jnp.int32)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ix = jnp.clip(ix, 0, w - 1)
        iy = jnp.clip(iy, 0, h - 1)
        out = img[iy, ix] * inside[..., None]
    else:
        x0 = jnp.floor(sx)
        y0 = jnp.floor(sy)
        fx = sx - x0
        fy = sy - y0
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)

        def gather(yy, xx):
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = img[jnp.clip(yy, 0, h - 1), jnp.clip(xx, 0, w - 1)]
            return v * inside[..., None]

        v00 = gather(y0i, x0i)
        v01 = gather(y0i, x0i + 1)
        v10 = gather(y0i + 1, x0i)
        v11 = gather(y0i + 1, x0i + 1)
        fx = fx[..., None]
        fy = fy[..., None]
        out = (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )

    return out[..., 0] if squeeze else out


def _source_coords(Hinv, h_out, w_out):
    ys = jnp.arange(h_out, dtype=jnp.float32)
    xs = jnp.arange(w_out, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)
    denom = Hinv[2, 0] * gx + Hinv[2, 1] * gy + Hinv[2, 2]
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    sx = (Hinv[0, 0] * gx + Hinv[0, 1] * gy + Hinv[0, 2]) / denom
    sy = (Hinv[1, 0] * gx + Hinv[1, 1] * gy + Hinv[1, 2]) / denom
    return sx, sy


def _clip_halfplane(poly, A, B, C):
    """Sutherland-Hodgman step: keep the part of convex ``poly`` (list of
    (x, y), ordered) where A*x + B*y + C >= 0."""
    res = []
    n = len(poly)
    for i in range(n):
        px, py = poly[i]
        qx, qy = poly[(i + 1) % n]
        fp = A * px + B * py + C
        fq = A * qx + B * qy + C
        if fp >= 0:
            res.append((px, py))
        if (fp < 0) != (fq < 0):
            t = fp / (fp - fq)
            res.append((px + t * (qx - px), py + t * (qy - py)))
    return res


def _point_in_convex(x, y, poly, tol=1e-9):
    sign = 0
    n = len(poly)
    for i in range(n):
        px, py = poly[i]
        qx, qy = poly[(i + 1) % n]
        cr = (qx - px) * (y - py) - (qy - py) * (x - px)
        if abs(cr) <= tol:
            continue
        s = 1 if cr > 0 else -1
        if sign == 0:
            sign = s
        elif s != sign:
            return False
    return True


def _quad_extremes(coef, poly):
    """Exact (min, max) of the quadratic q(x, y) = p20 x^2 + p11 x y +
    p02 y^2 + p10 x + p01 y + p00 over a convex polygon: vertices, edge
    restrictions (1D quadratics — endpoint + vertex), and the interior
    critical point when the Hessian is nonsingular. With a singular
    Hessian the quadratic is (semi-)definite along one direction and
    linear/constant along the null direction, so every extremum is
    attained on the boundary, which the edge analysis covers."""
    p20, p11, p02, p10, p01, p00 = coef

    def ev(x, y):
        return (p20 * x * x + p11 * x * y + p02 * y * y
                + p10 * x + p01 * y + p00)

    vals = [ev(x, y) for x, y in poly]
    det_h = 4.0 * p20 * p02 - p11 * p11
    if abs(det_h) > 1e-30:
        xc = (-2.0 * p02 * p10 + p11 * p01) / det_h
        yc = (-2.0 * p20 * p01 + p11 * p10) / det_h
        if _point_in_convex(xc, yc, poly):
            vals.append(ev(xc, yc))
    n = len(poly)
    for i in range(n):
        px, py = poly[i]
        qx, qy = poly[(i + 1) % n]
        dx, dy = qx - px, qy - py
        a = p20 * dx * dx + p11 * dx * dy + p02 * dy * dy
        if abs(a) > 1e-30:
            b = (2.0 * p20 * px * dx + p11 * (px * dy + py * dx)
                 + 2.0 * p02 * py * dy + p10 * dx + p01 * dy)
            t = -b / (2.0 * a)
            if 0.0 < t < 1.0:
                vals.append(ev(px + t * dx, py + t * dy))
    return min(vals), max(vals)


def band_budget(H, out_shape, src_shape, classes=(2, 4, 8, 16, 32, 64)):
    """Host-side: smallest (dy, dx) budget class covering |sy-y| / |sx-x|
    over the output grid for homography ``H`` (numpy, f64), or ``None``
    if the warp displaces farther than the largest class (fall back to
    the gather warp).

    CERTIFIED, not sampled (r3 finding: a 9x9 grid can miss a
    displacement extremum between samples, silently zeroing pixels).
    Only the *live region* constrains the band — destination pixels whose
    source point falls outside the image produce zero through both the
    band and the gather warp. With the denominator den = g x + h y + w
    of the Moebius map strictly one-signed over the canvas (checked at
    the corners; linear => everywhere), the live region
    {-1 < sx < ws, -1 < sy < hs} is the canvas rectangle clipped by four
    half-planes (each bound times den is linear), i.e. a convex polygon.
    Over it, sx - x = P(x, y)/den with P quadratic, so the exact extrema
    of P and den are closed-form (``_quad_extremes``; den is linear =>
    vertices) and hull{P_ext/den_ext} bounds the displacement from
    above. A sign-crossing or near-zero denominator means a pole inside
    the canvas — the one case where a thin live sliver beyond the pole
    can carry arbitrary displacement — and returns None (gather path).
    The +1.5 class margin covers the floor/ceil tap offset (+1) plus
    headroom."""
    import numpy as np

    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    h_out, w_out = out_shape
    hs, ws = src_shape[:2]
    box = [(0.0, 0.0), (float(w_out - 1), 0.0),
           (float(w_out - 1), float(h_out - 1)), (0.0, float(h_out - 1))]
    g, hh, w0 = Hinv[2]
    dens = [g * x + hh * y + w0 for x, y in box]
    if not (min(dens) > 1e-9 or max(dens) < -1e-9):
        return None                           # pole in/near the canvas
    if dens[0] < 0:                           # normalize: den > 0 on box
        Hinv = -Hinv
        g, hh, w0 = Hinv[2]
    a, b, c = Hinv[0]
    d, e, f = Hinv[1]

    # live region = box clipped by (inequality * den, den > 0):
    #   sx > -1:  num_x + den > 0
    #   sx < ws:  ws*den - num_x > 0
    #   sy > -1:  num_y + den > 0
    #   sy < hs:  hs*den - num_y > 0
    poly = box
    for A, B, C in (
        (a + g, b + hh, c + w0),
        (ws * g - a, ws * hh - b, ws * w0 - c),
        (d + g, e + hh, f + w0),
        (hs * g - d, hs * hh - e, hs * w0 - f),
    ):
        poly = _clip_halfplane(poly, A, B, C)
        if len(poly) < 3:
            return classes[0], classes[0]     # no live pixels at all

    den_vals = [g * x + hh * y + w0 for x, y in poly]
    den_lo, den_hi = min(den_vals), max(den_vals)
    if den_lo <= 1e-9:
        return None

    def disp_bound(coef):
        lo, hi = _quad_extremes(coef, poly)
        return max(abs(v) for v in
                   (lo / den_lo, lo / den_hi, hi / den_lo, hi / den_hi))

    # sx - x = P/den, P = num_x - x*den = -g x^2 - h x y + (a-w)x + b y + c
    dx = disp_bound((-g, -hh, 0.0, a - w0, b, c))
    # sy - y = Q/den, Q = num_y - y*den = -h y^2 - g x y + d x + (e-w)y + f
    dy = disp_bound((0.0, -g, -hh, d, e - w0, f))

    dy_c = next((cl for cl in classes if cl >= dy + 1.5), None)
    dx_c = next((cl for cl in classes if cl >= dx + 1.5), None)
    if dy_c is None or dx_c is None:
        return None
    return dy_c, dx_c


@functools.partial(
    jax.jit, static_argnames=("out_shape", "dy_budget", "dx_budget", "method"))
def warp_band(
    image: jnp.ndarray,          # (H, W) or (H, W, C)
    H: jnp.ndarray,              # (3, 3) SOURCE -> DEST
    out_shape: Tuple[int, int],
    dy_budget: int,
    dx_budget: int,
    method: str = "bilinear",
) -> jnp.ndarray:
    """Gather-free perspective warp for small-displacement homographies.

    Rectification homographies displace pixels by only a few px
    (Loop-Zhang H is
    near-identity for near-rectified pairs), so the 4 bilinear taps of
    every output pixel live in a static (2*dy+1) x (2*dx+1) band around
    it. The warp is then an exact shift-and-accumulate:

        out[y, x] = sum_{k, j} hat(sy - (y+k)) * hat(sx - (x+j))
                               * img[y+k, x+j]

    over static shifts (k, j) — pure fused multiply-adds on static slices, no
    gather. All terms outside the true 4 taps are exactly zero (hat
    clamps), so this IS bilinear interpolation, not an approximation;
    ``method="nearest"`` uses round-indicator weights (identical
    semantics to the gather path incl. zero outside the source).

    Budgets are static; ``band_budget`` picks them on host from H. The
    caller must fall back to ``warp_perspective`` when it returns None.
    """
    h_out, w_out = out_shape
    hs, ws = image.shape[:2]
    squeeze = image.ndim == 2
    img = image[..., None] if squeeze else image
    img = img.astype(jnp.float32)

    Hinv = jnp.linalg.inv(H.astype(jnp.float32))
    sx, sy = _source_coords(Hinv, h_out, w_out)

    DY, DX = dy_budget, dx_budget
    # zero-pad the source so every (y+k, x+j) tap is in-bounds: rows
    # [-DY, h_out+DY), cols [-DX, w_out+DX)
    img_p = jnp.pad(
        img,
        ((DY, max(0, h_out + DY - hs)),
         (DX, max(0, w_out + DX - ws)),
         (0, 0)),
    )

    ys = jnp.arange(h_out, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w_out, dtype=jnp.float32)[None, :]

    if method == "nearest":
        ry = jnp.round(sy)
        rx = jnp.round(sx)
        wy = lambda k: (ry == ys + k).astype(jnp.float32)
        wx = lambda j: (rx == xs + j).astype(jnp.float32)
    else:
        wy = lambda k: jnp.maximum(0.0, 1.0 - jnp.abs(sy - (ys + k)))
        wx = lambda j: jnp.maximum(0.0, 1.0 - jnp.abs(sx - (xs + j)))

    # horizontal weights are k-independent: precompute once
    u = [wx(j - DX) for j in range(2 * DX + 1)]

    # the row-shift axis runs under lax.fori_loop (traced k), keeping
    # only the 2*DX+1 column terms unrolled: identical arithmetic to the
    # fully unrolled (2*DY+1)*(2*DX+1)-term graph (561 terms at the
    # (8, 16) band class) in a ~17x smaller graph that compiles faster
    def row_term(k, acc):
        rows_k = lax.dynamic_slice(
            img_p, (k, 0, 0), (h_out, img_p.shape[1], img_p.shape[2]))
        hval = jnp.zeros_like(acc)
        for j in range(2 * DX + 1):
            shifted = lax.slice(
                rows_k, (0, j, 0), (h_out, j + w_out, img_p.shape[2]))
            hval = hval + u[j][..., None] * shifted
        kf = (k - DY).astype(jnp.float32)
        return acc + wy(kf)[..., None] * hval

    acc = lax.fori_loop(
        0, 2 * DY + 1, row_term,
        jnp.zeros((h_out, w_out, img.shape[-1]), jnp.float32))

    return acc[..., 0] if squeeze else acc


def transform_points(H: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """cv::perspectiveTransform equivalent: (..., 2, N) points through H."""
    from stereo_reconstruction.ops import geometry as geo

    hom = geo.to_homogeneous(points) if points.shape[-2] == 2 else points
    mapped = H @ hom
    return mapped[..., :2, :] / mapped[..., 2:3, :]
