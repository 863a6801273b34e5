"""ORB-style binary frontend: FAST detection, rBRIEF, Hamming matching.

Covers the reference's uncalibrated frontend
(src/rectification_main.cpp:26-112): cv::ORB detection + BFMatcher
NORM_HAMMING crossCheck matching.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import BriskConfig, OrbConfig
from stereo_reconstruction.ops.binary_features import (
    _brisk_pattern,
    detect_and_describe_brisk,
    detect_and_describe_orb,
)
from stereo_reconstruction.ops.features import Keypoints
from stereo_reconstruction.ops.matching import match_descriptors_binary


def _texture(h, w, seed=0):
    """Smooth random texture with plenty of corners."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h + 64, w + 64)).astype(np.float32)
    # box-blur twice for smooth blobs
    k = np.ones(5) / 5
    for axis in (0, 1):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), axis, img)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img


CFG = OrbConfig(max_keypoints=256, num_levels=2)


def test_detects_square_corners():
    img = np.zeros((96, 96), np.float32)
    img[32:64, 32:64] = 200.0
    kp = detect_and_describe_orb(jnp.asarray(img), OrbConfig(max_keypoints=32, num_levels=1))
    xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
    assert len(xy) >= 4
    corners = np.array([[32, 32], [63, 32], [32, 63], [63, 63]], np.float32)
    # every true corner has a detection within 3 px
    for c in corners:
        assert np.min(np.linalg.norm(xy - c, axis=1)) < 3.0


def test_hamming_matmul_equals_popcount():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (64, 256)).astype(np.float32)
    b = rng.integers(0, 2, (64, 256)).astype(np.float32)
    xy = jnp.zeros((64, 2))
    kpa = Keypoints(xy=xy + jnp.arange(64)[:, None], scale=jnp.ones(64),
                    response=jnp.ones(64), orientation=jnp.zeros(64),
                    descriptors=jnp.asarray(a), valid=jnp.ones(64, bool))
    kpb = kpa._replace(descriptors=jnp.asarray(b))
    m = match_descriptors_binary(kpa, kpb)
    ham = (a[:, None, :] != b[None, :, :]).sum(-1)        # exact popcount
    nn = ham.argmin(1)
    d = ham[np.arange(64), nn]
    np.testing.assert_array_equal(np.asarray(m.distance), d.astype(np.float32))


def test_orientation_rotates_descriptor():
    """Descriptors must be (approximately) rotation-invariant: the same
    patch rotated 90 deg keeps a small Hamming distance."""
    img = _texture(128, 128, seed=3)[:128, :128]
    rot = np.rot90(img).copy()
    kp1 = detect_and_describe_orb(jnp.asarray(img), CFG)
    kp2 = detect_and_describe_orb(jnp.asarray(rot), CFG)
    m = match_descriptors_binary(kp1, kp2)
    v = np.asarray(m.valid)
    assert v.sum() >= 20
    # rot90 maps (x, y) -> (y, W-1-x); most matches must respect it
    lx = np.asarray(m.left_xy)[v]
    rx = np.asarray(m.right_xy)[v]
    expect = np.stack([lx[:, 1], 127 - lx[:, 0]], axis=1)
    good = np.linalg.norm(rx - expect, axis=1) < 2.0
    assert good.mean() > 0.6


def test_translation_matching():
    """Shifted pair: matched keypoints recover the shift."""
    base = _texture(160, 224, seed=7)
    dx = 9
    left = base[16:144, 16:208]
    right = base[16:144, 16 + dx : 208 + dx]   # right view shifted
    kl = detect_and_describe_orb(jnp.asarray(left), CFG)
    kr = detect_and_describe_orb(jnp.asarray(right), CFG)
    m = match_descriptors_binary(kl, kr)
    v = np.asarray(m.valid)
    assert v.sum() >= 30
    disp = np.asarray(m.left_xy)[v] - np.asarray(m.right_xy)[v]
    good = (np.abs(disp[:, 0] - dx) < 1.5) & (np.abs(disp[:, 1]) < 1.5)
    assert good.mean() > 0.6


# --- BRISK variant (reference rectification_main.cpp:46-51) ----------------

BRISK_CFG = BriskConfig(max_keypoints=256, octaves=1)


def test_brisk_pattern_geometry():
    """60 points on the paper's ring ladder; short/long pair split at the
    cv::BRISK cutoffs (dMax 5.85, dMin 8.2 at patternScale 1)."""
    pts, ring, sigmas, short, long_, long_dir = _brisk_pattern(1.0, 512)
    assert pts.shape == (60, 2) and ring.shape == (60,)
    assert sigmas.shape == (5,) and (sigmas >= 0.5).all()
    d_short = np.linalg.norm(pts[short[:, 1]] - pts[short[:, 0]], axis=1)
    d_long = np.linalg.norm(pts[long_[:, 1]] - pts[long_[:, 0]], axis=1)
    assert (d_short < 5.85).all() and (d_long > 8.2).all()
    assert 128 <= len(short) <= 512 and len(long_) > 100
    # orientation factors are (p_j - p_i)/|p_j - p_i|^2
    np.testing.assert_allclose(
        np.linalg.norm(long_dir, axis=1), 1.0 / d_long, rtol=1e-5)


def test_brisk_detects_square_corners():
    img = np.zeros((96, 96), np.float32)
    img[40:72, 40:72] = 200.0
    kp = detect_and_describe_brisk(
        jnp.asarray(img), BriskConfig(max_keypoints=32, octaves=1))
    xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
    assert len(xy) >= 4
    corners = np.array([[40, 40], [71, 40], [40, 71], [71, 71]], np.float32)
    for c in corners:
        assert np.min(np.linalg.norm(xy - c, axis=1)) < 3.0


def test_brisk_translation_matching():
    base = _texture(160, 224, seed=11)
    dx = 7
    left = base[16:144, 16:208]
    right = base[16:144, 16 + dx : 208 + dx]
    kl = detect_and_describe_brisk(jnp.asarray(left), BRISK_CFG)
    kr = detect_and_describe_brisk(jnp.asarray(right), BRISK_CFG)
    m = match_descriptors_binary(kl, kr)
    v = np.asarray(m.valid)
    assert v.sum() >= 30
    disp = np.asarray(m.left_xy)[v] - np.asarray(m.right_xy)[v]
    good = (np.abs(disp[:, 0] - dx) < 1.5) & (np.abs(disp[:, 1]) < 1.5)
    assert good.mean() > 0.6


def test_brisk_orientation_rotates_descriptor():
    img = _texture(128, 128, seed=13)[:128, :128]
    rot = np.rot90(img).copy()
    kp1 = detect_and_describe_brisk(jnp.asarray(img), BRISK_CFG)
    kp2 = detect_and_describe_brisk(jnp.asarray(rot), BRISK_CFG)
    m = match_descriptors_binary(kp1, kp2)
    v = np.asarray(m.valid)
    assert v.sum() >= 20
    lx = np.asarray(m.left_xy)[v]
    rx = np.asarray(m.right_xy)[v]
    expect = np.stack([lx[:, 1], 127 - lx[:, 0]], axis=1)
    good = np.linalg.norm(rx - expect, axis=1) < 2.0
    assert good.mean() > 0.6


def test_brisk_default_multi_octave_ladder():
    """Default BriskConfig (octaves=3): the full octave/intra-octave
    ladder (scales 1, 1.5, 2, 3, 4, 6) with cross-level top-K and
    coordinate rescaling — the path the octaves=1 unit tests never
    exercised (ADVICE r4)."""
    base = _texture(288, 288, seed=23)
    dx = 6
    left = base[16:272, 16:264]
    right = base[16:272, 16 + dx : 264 + dx]
    cfg = BriskConfig(max_keypoints=256)          # defaults: octaves=3
    kl = detect_and_describe_brisk(jnp.asarray(left), cfg)
    kr = detect_and_describe_brisk(jnp.asarray(right), cfg)
    vl = np.asarray(kl.valid)
    scales = np.asarray(kl.scale)[vl]
    # winners from more than one ladder level survive the global top-K
    assert len(np.unique(scales)) >= 2
    # rescaled coordinates stay inside the ORIGINAL image frame
    xy = np.asarray(kl.xy)[vl]
    assert (xy >= 0).all()
    assert (xy[:, 0] <= left.shape[0] - 1).all()
    assert (xy[:, 1] <= left.shape[1] - 1).all()
    # and the cross-level descriptors still match a translated copy
    m = match_descriptors_binary(kl, kr)
    v = np.asarray(m.valid)
    assert v.sum() >= 30
    disp = np.asarray(m.left_xy)[v] - np.asarray(m.right_xy)[v]
    good = (np.abs(disp[:, 0] - dx) < 1.5) & (np.abs(disp[:, 1]) < 1.5)
    assert good.mean() > 0.5


def test_too_small_image_raises():
    """Images below one level's minimum (2*edge_margin+8) must raise a
    clear error, not an opaque empty-concatenate (ADVICE r4)."""
    tiny = jnp.zeros((24, 24))
    with pytest.raises(ValueError, match="smaller than one BRISK level"):
        detect_and_describe_brisk(tiny, BriskConfig())
    with pytest.raises(ValueError, match="smaller than one ORB level"):
        detect_and_describe_orb(tiny, OrbConfig())


def test_brisk_descriptor_binary_and_deterministic():
    img = _texture(96, 96, seed=17)[:96, :96]
    kp1 = detect_and_describe_brisk(jnp.asarray(img), BRISK_CFG)
    kp2 = detect_and_describe_brisk(jnp.asarray(img), BRISK_CFG)
    d = np.asarray(kp1.descriptors)
    assert set(np.unique(d[np.asarray(kp1.valid)])) <= {0.0, 1.0}
    np.testing.assert_array_equal(d, np.asarray(kp2.descriptors))
    assert np.asarray(kp1.valid).sum() > 0


def test_descriptor_binary_and_deterministic():
    img = _texture(96, 96, seed=5)[:96, :96]
    kp1 = detect_and_describe_orb(jnp.asarray(img), CFG)
    kp2 = detect_and_describe_orb(jnp.asarray(img), CFG)
    d = np.asarray(kp1.descriptors)
    assert set(np.unique(d)) <= {0.0, 1.0}
    np.testing.assert_array_equal(d, np.asarray(kp2.descriptors))
    assert np.asarray(kp1.valid).sum() > 0
