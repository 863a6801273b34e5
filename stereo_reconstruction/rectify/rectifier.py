"""Rectify a stereo pair and bridge disparity back to the original frame.

Equivalent of the reference ``ImageRectifier`` orchestration
(rectification.cpp:53-88,432-497): compute Loop-Zhang homographies (host,
float64), warp both images into rectified canvases on device, transform
the match points, and, after dense matching, warp the disparity map back
to the original frame with nearest-neighbor sampling.

Device specifics:
  * the rectified canvas is a static budget ``ceil(canvas_scale * input)``
    rounded up to a multiple of 128 on the width — the
    reference's data-dependent canvases (rectification.cpp:437-484) don't
    jit. The true data canvas is reported for cropping.
  * the disparity back-warp uses the correct per-image homography (the
    reference warps the right-image disparity with the *left* homography
    inverse, rectification.cpp:78-88 — a bug we do not replicate;
    ``compat_left_homography=True`` restores it for A/B parity runs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.config import RectifyConfig
from stereo_reconstruction.ops.warp import (
    band_budget,
    transform_points,
    warp_band,
    warp_perspective,
)
from stereo_reconstruction.rectify.loop_zhang import (
    RectifyHomographies,
    loop_zhang_homographies,
)


@dataclasses.dataclass(frozen=True)
class RectifiedPair:
    left: jnp.ndarray             # (Hc, Wc, 3) rectified left image
    right: jnp.ndarray            # (Hc, Wc, 3) rectified right image
    homographies: RectifyHomographies
    matches_left: Optional[jnp.ndarray] = None    # (2, N) rectified matches
    matches_right: Optional[jnp.ndarray] = None
    canvas: Tuple[int, int] = (0, 0)              # static canvas used


def static_canvas(
    shape_left, shape_right, config: RectifyConfig, lane: int = 128
) -> Tuple[int, int]:
    h = max(shape_left[0], shape_right[0])
    w = max(shape_left[1], shape_right[1])
    hc = int(np.ceil(h * config.canvas_scale))
    wc = int(np.ceil(w * config.canvas_scale))
    return (hc + (-hc) % 8, wc + (-wc) % lane)


def rectify_pair(
    image_left: jnp.ndarray,
    image_right: jnp.ndarray,
    F: np.ndarray,
    matches_left: Optional[jnp.ndarray] = None,   # (2 or 3, N) pixel coords
    matches_right: Optional[jnp.ndarray] = None,
    config: RectifyConfig = RectifyConfig(),
) -> RectifiedPair:
    homs = loop_zhang_homographies(
        np.asarray(F, np.float64),
        tuple(image_left.shape[:2]),
        tuple(image_right.shape[:2]),
    )
    canvas = static_canvas(image_left.shape, image_right.shape, config)

    Hl = jnp.asarray(homs.H_left, jnp.float32)
    Hr = jnp.asarray(homs.H_right, jnp.float32)
    rect_left = _warp_auto(image_left, homs.H_left, Hl, canvas)
    rect_right = _warp_auto(image_right, homs.H_right, Hr, canvas)

    ml = mr = None
    if matches_left is not None:
        ml = transform_points(Hl, jnp.asarray(matches_left, jnp.float32)[:2])
        mr = transform_points(Hr, jnp.asarray(matches_right, jnp.float32)[:2])

    return RectifiedPair(
        left=rect_left,
        right=rect_right,
        homographies=homs,
        matches_left=ml,
        matches_right=mr,
        canvas=canvas,
    )


def _warp_auto(image, H_host, H_dev, out_shape, method="bilinear"):
    """Pick the gather-free band warp when the host-known homography
    displaces pixels by only a small static band (the common case for
    Loop-Zhang rectification), else the general gather warp. Same
    results either way (ops/warp.py warp_band docstring)."""
    budget = band_budget(np.asarray(H_host, np.float64), out_shape,
                         image.shape[:2])
    if budget is None:
        return warp_perspective(image, H_dev, out_shape, method=method)
    return warp_band(image, H_dev, out_shape, budget[0], budget[1],
                     method=method)


def disparity_to_original_frame(
    disparity_rect: jnp.ndarray,      # (Hc, Wc) disparity in rectified frame
    H: np.ndarray,                    # homography used for that image
    out_shape: Tuple[int, int],       # original (H, W)
    compat_left_homography: Optional[np.ndarray] = None,
) -> jnp.ndarray:
    """Nearest-neighbor back-warp of disparity *values* (the reference's
    known approximation: values are resampled, not re-projected;
    rectification.cpp:70-88)."""
    Hu = compat_left_homography if compat_left_homography is not None else H
    # dst(p) = src(H p): warpPerspective with M = H^{-1}, i.e. inverse map H
    Hu = np.asarray(Hu, np.float64)
    return _warp_auto(
        disparity_rect,
        np.linalg.inv(Hu),
        jnp.linalg.inv(jnp.asarray(Hu, jnp.float32)),
        out_shape,
        method="nearest",
    )
