"""Uncalibrated rectification pipeline (the reference's second frontend).

Equivalent of ``src/rectification_main.cpp:157-217``: detect + match
features, estimate F directly with RANSAC (no intrinsics), Loop-Zhang
rectify, run the linear (1x1) search, re-estimate F on the rectified pair.
The reference's ORB + Hamming matching (rectification_main.cpp:26-112)
maps to ops/binary_features.py (FAST/Harris/rBRIEF) with brute-force
Hamming cross-check matching as one matmul; a DoG/SIFT frontend is
available via ``detector="dog"``. The F path is the normalized-8-point
RANSAC of pose/fundamental.py (cv::findFundamentalMat FM_8POINT|FM_RANSAC
equivalent).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.config import PipelineConfig
from stereo_reconstruction.ops.binary_features import (
    detect_and_describe_brisk,
    detect_and_describe_orb,
)
from stereo_reconstruction.ops.features import detect_and_describe
from stereo_reconstruction.ops.linear_search import linear_search
from stereo_reconstruction.ops.matching import (
    match_descriptors,
    match_descriptors_binary,
    matches_to_homogeneous,
)
from stereo_reconstruction.pose.fundamental import ransac_fundamental
from stereo_reconstruction.rectify.rectifier import rectify_pair


@dataclasses.dataclass
class UncalibratedResult:
    F: np.ndarray                 # estimated fundamental matrix
    F_rectified: Optional[np.ndarray]   # F re-estimated on rectified pair
    disparity: np.ndarray         # (Hc, Wc) linear-search disparity
    rectified_left: np.ndarray
    rectified_right: np.ndarray
    num_inliers: int
    # rectification quality: mean |y_left - y_right| over the F-inlier
    # matches AFTER warping by the Loop-Zhang homographies — rectified
    # correspondences must share scanlines (the property the whole
    # pipeline exists to establish; gated in tests/test_uncalibrated.py)
    epipolar_alignment_px: float = float("nan")


def run_uncalibrated(
    image_left,
    image_right,
    config: PipelineConfig = PipelineConfig(),
    key=None,
    detector: str = "orb",
    output_dir: str = None,
) -> UncalibratedResult:
    """``detector``: "orb" = binary FAST/rBRIEF + brute-force Hamming
    cross-check (the reference's default, rectification_main.cpp:126-129);
    "brisk" = the reference's alternative detector
    (rectification_main.cpp:46-51), ring-pattern 512-bit descriptors with
    the same Hamming matching; "dog" = the calibrated path's DoG/SIFT
    frontend + L2 ratio matching.

    ``output_dir``: when given, writes the rectified pair with rendered
    epilines + the disparity map as PNGs (rectification_main.cpp:204-214).
    """
    key = jax.random.key(config.seed) if key is None else key
    if detector in ("orb", "brisk"):
        detect = (detect_and_describe_orb if detector == "orb"
                  else detect_and_describe_brisk)
        cfg = config.orb if detector == "orb" else config.brisk
        kp_l = detect(jnp.asarray(image_left), cfg)
        kp_r = detect(jnp.asarray(image_right), cfg)
        matches = match_descriptors_binary(kp_l, kp_r)
    else:
        kp_l = detect_and_describe(jnp.asarray(image_left), config.frontend)
        kp_r = detect_and_describe(jnp.asarray(image_right), config.frontend)
        matches = match_descriptors(kp_l, kp_r, config.frontend)
    ml, mr, valid = matches_to_homogeneous(matches)

    order = np.argsort(~np.asarray(valid), kind="stable")
    ml = jnp.asarray(np.asarray(ml)[:, order])
    mr = jnp.asarray(np.asarray(mr)[:, order])
    n_valid = int(np.asarray(valid).sum())

    fr = ransac_fundamental(key, ml, mr, num_matches_valid=n_valid)
    F = np.asarray(fr.F, np.float64)

    inl = np.asarray(fr.inlier_mask)
    rect = rectify_pair(
        jnp.asarray(image_left),
        jnp.asarray(image_right),
        F,
        matches_left=jnp.asarray(np.asarray(ml)[:, inl]),
        matches_right=jnp.asarray(np.asarray(mr)[:, inl]),
        config=config.rectify,
    )

    disparity = linear_search(
        rect.left, rect.right,
        smooth_factor=config.matcher.smooth_factor,
        search_range=config.matcher.max_disparity,
    )

    # re-estimate F on the rectified matches (rectification_main.cpp:199-202)
    F_rect = None
    if rect.matches_left is not None and n_valid >= 8:
        ones = jnp.ones((1, rect.matches_left.shape[1]))
        rml = jnp.concatenate([rect.matches_left, ones], axis=0)
        rmr = jnp.concatenate([rect.matches_right, ones], axis=0)
        fr2 = ransac_fundamental(
            jax.random.split(key)[0], rml, rmr,
            num_matches_valid=int(inl.sum()),
        )
        F_rect = np.asarray(fr2.F, np.float64)

    align = float("nan")
    if rect.matches_left is not None and int(inl.sum()) > 0:
        dy = np.abs(np.asarray(rect.matches_left)[1]
                    - np.asarray(rect.matches_right)[1])
        align = float(np.mean(dy))

    result = UncalibratedResult(
        F=F,
        F_rectified=F_rect,
        disparity=np.asarray(disparity),
        rectified_left=np.asarray(rect.left),
        rectified_right=np.asarray(rect.right),
        num_inliers=int(fr.num_inliers),
        epipolar_alignment_px=align,
    )

    if output_dir:
        import os

        from stereo_reconstruction.io.image import write_image
        from stereo_reconstruction.rectify.epilines import (
            draw_rectified_epilines,
        )

        os.makedirs(output_dir, exist_ok=True)
        el, er = result.rectified_left, result.rectified_right
        if F_rect is not None and rect.matches_left is not None:
            el, er = draw_rectified_epilines(
                el, er, F_rect,
                np.asarray(rect.matches_left).T,
                np.asarray(rect.matches_right).T,
            )
        write_image(os.path.join(output_dir, "rectified_left.png"), el)
        write_image(os.path.join(output_dir, "rectified_right.png"), er)
        write_image(os.path.join(output_dir, "disparity_linear.png"),
                    result.disparity)

    return result
