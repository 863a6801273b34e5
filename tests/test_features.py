"""Feature detection + matching tests.

Correctness criteria are functional (the frontend feeds pose estimation):
keypoints land on repeatable structures, and matching across a known
translation recovers that translation for the bulk of matches.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import FrontendConfig
from stereo_reconstruction.ops.features import (
    detect_and_describe,
    gaussian_blur,
    rgb_to_gray,
)
from stereo_reconstruction.ops.matching import (
    match_descriptors,
    matches_to_homogeneous,
)


def _textured_image(rng, h=160, w=200, blobs=40):
    img = np.zeros((h, w), np.float32)
    ys = rng.integers(10, h - 10, blobs)
    xs = rng.integers(10, w - 10, blobs)
    amps = rng.uniform(60, 200, blobs)
    sigs = rng.uniform(1.5, 4.0, blobs)
    yy, xx = np.mgrid[0:h, 0:w]
    for y, x, a, s in zip(ys, xs, amps, sigs):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    img = np.clip(img + rng.normal(0, 2, (h, w)), 0, 255)
    return np.repeat(img[..., None], 3, axis=2).astype(np.uint8)


def test_gaussian_blur_preserves_mean(rng):
    img = jnp.asarray(rng.uniform(0, 1, (64, 64)).astype(np.float32))
    out = gaussian_blur(img, 2.0)
    np.testing.assert_allclose(float(out.mean()), float(img.mean()), rtol=1e-2)
    assert float(out.std()) < float(img.std())


def test_rgb_to_gray_weights():
    img = jnp.asarray(np.array([[[100, 0, 0]], [[0, 100, 0]], [[0, 0, 100]]], np.uint8))
    g = np.asarray(rgb_to_gray(img))
    np.testing.assert_allclose(g.squeeze(), [29.9, 58.7, 11.4], rtol=1e-3)


def test_detector_finds_blobs(rng):
    img = _textured_image(rng)
    cfg = FrontendConfig(max_keypoints=200, num_octaves=3)
    kp = detect_and_describe(jnp.asarray(img), cfg)
    n_valid = int(np.asarray(kp.valid).sum())
    assert n_valid > 30, f"only {n_valid} keypoints detected"
    # keypoints are inside the image
    xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < img.shape[1]).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < img.shape[0]).all()
    # descriptors unit-normalized
    d = np.asarray(kp.descriptors)[np.asarray(kp.valid)]
    norms = np.linalg.norm(d, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_matching_recovers_translation(rng):
    img = _textured_image(rng, h=160, w=220)
    shift = 18
    right = np.roll(img, -shift, axis=1)   # right image shifted left by 18px
    cfg = FrontendConfig(max_keypoints=200, num_octaves=3, ratio_threshold=0.8)

    kp_l = detect_and_describe(jnp.asarray(img), cfg)
    kp_r = detect_and_describe(jnp.asarray(right), cfg)
    matches = match_descriptors(kp_l, kp_r, cfg)

    valid = np.asarray(matches.valid)
    assert valid.sum() >= 15, f"only {valid.sum()} matches"
    dx = np.asarray(matches.left_xy)[valid, 0] - np.asarray(matches.right_xy)[valid, 0]
    dy = np.asarray(matches.left_xy)[valid, 1] - np.asarray(matches.right_xy)[valid, 1]
    # most matches recover the known shift
    good = (np.abs(dx - shift) < 2.0) & (np.abs(dy) < 2.0)
    assert good.mean() > 0.7, f"only {good.mean():.0%} matches at the true shift"


def test_matches_to_homogeneous_layout(rng):
    img = _textured_image(rng)
    cfg = FrontendConfig(max_keypoints=64, num_octaves=2)
    kp = detect_and_describe(jnp.asarray(img), cfg)
    matches = match_descriptors(kp, kp, cfg)
    left, right, valid = matches_to_homogeneous(matches)
    assert left.shape[0] == 3 and right.shape[0] == 3
    np.testing.assert_array_equal(np.asarray(left[2]), 1.0)
    # self-matching: every valid match maps a keypoint to itself
    v = np.asarray(valid)
    np.testing.assert_allclose(
        np.asarray(left)[:2, v], np.asarray(right)[:2, v], atol=1e-4
    )
