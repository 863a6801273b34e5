"""Rectification tests.

The decisive property of Loop-Zhang rectification: after applying the two
homographies, corresponding points lie on the same image row (epipolar
lines horizontal and aligned). The warp op is cross-validated against
OpenCV's warpPerspective (cv2 is available in the test image only as an
oracle — the framework itself never imports it).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.ops.warp import transform_points, warp_perspective
from stereo_reconstruction.rectify import (
    disparity_to_original_frame,
    loop_zhang_homographies,
    rectify_pair,
)


def _synthetic_F(rng, w=320, h=240):
    """F from a known stereo geometry + projected match points."""
    K = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2], [0, 0, 1]], np.float64)
    R = np.asarray(geo.angle_axis_to_rotation(jnp.asarray([0.02, -0.08, 0.01])), np.float64)
    T = np.array([-1.0, 0.05, 0.15])
    T /= np.linalg.norm(T)
    E = np.asarray(geo.skew(jnp.asarray(T))) @ R
    F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
    F /= np.linalg.norm(F)

    n = 40
    depths = rng.uniform(4, 10, n)
    xl = np.concatenate([rng.uniform(-0.3, 0.3, (2, n)), np.ones((1, n))])
    pts = xl * depths
    pts_r = R @ pts + T[:, None]
    kp_l = (K @ (pts / pts[2:3]))[:2]
    kp_r = (K @ (pts_r / pts_r[2:3]))[:2]
    inside = (
        (kp_l[0] >= 0) & (kp_l[0] < w) & (kp_l[1] >= 0) & (kp_l[1] < h)
        & (kp_r[0] >= 0) & (kp_r[0] < w) & (kp_r[1] >= 0) & (kp_r[1] < h)
    )
    return F, kp_l[:, inside], kp_r[:, inside], (h, w)


def test_epipolar_alignment_after_rectification(rng):
    F, kp_l, kp_r, (h, w) = _synthetic_F(rng)
    homs = loop_zhang_homographies(F, (h, w), (h, w))

    tl = np.asarray(transform_points(jnp.asarray(homs.H_left, jnp.float32), jnp.asarray(kp_l, jnp.float32)))
    tr = np.asarray(transform_points(jnp.asarray(homs.H_right, jnp.float32), jnp.asarray(kp_r, jnp.float32)))

    dy = np.abs(tl[1] - tr[1])
    # matched rows must align to ~subpixel scale relative to canvas height
    assert np.median(dy) < 1.5, f"median row misalignment {np.median(dy):.2f}px"
    assert np.percentile(dy, 90) < 3.0


def test_rectified_epipole_at_infinity(rng):
    """The left homography must send the epipole to infinity (third
    homogeneous coordinate ~ 0 relative to the others)."""
    F, _, _, (h, w) = _synthetic_F(rng)
    homs = loop_zhang_homographies(F, (h, w), (h, w))
    e = homs.epipole / np.linalg.norm(homs.epipole)
    mapped = homs.H_left @ e
    assert abs(mapped[2]) < 1e-3 * np.linalg.norm(mapped[:2])


def test_warp_matches_opencv_bilinear(rng):
    img = rng.integers(0, 255, (60, 80, 3), np.uint8)
    H = np.array([[1.05, 0.1, 3.0], [-0.08, 0.98, 2.0], [1e-4, -5e-5, 1.0]])
    want = cv2.warpPerspective(img.astype(np.float32), H.astype(np.float64), (96, 72))
    got = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(H, jnp.float32), (72, 96)))
    # interior agreement (border rows differ by border handling)
    diff = np.abs(want[4:-4, 4:-4] - got[4:-4, 4:-4])
    assert np.percentile(diff, 99) < 3.0, f"p99 diff {np.percentile(diff, 99)}"


def test_warp_matches_opencv_nearest(rng):
    img = rng.uniform(0, 100, (50, 70)).astype(np.float32)
    H = np.array([[0.9, 0.05, 5.0], [0.02, 1.1, -2.0], [0.0, 0.0, 1.0]])
    want = cv2.warpPerspective(img, H, (80, 60), flags=cv2.INTER_NEAREST)
    got = np.asarray(warp_perspective(jnp.asarray(img), jnp.asarray(H, jnp.float32), (60, 80), method="nearest"))
    mismatch = np.mean(want[2:-2, 2:-2] != got[2:-2, 2:-2])
    # NN rounding at exact .5 boundaries may differ on scattered pixels
    assert mismatch < 0.02, f"{mismatch:.3%} nearest-neighbor mismatches"


@pytest.mark.slow
def test_rectify_pair_and_backwarp(rng):
    F, kp_l, kp_r, (h, w) = _synthetic_F(rng)
    img_l = jnp.asarray(rng.integers(0, 255, (h, w, 3), np.uint8))
    img_r = jnp.asarray(rng.integers(0, 255, (h, w, 3), np.uint8))
    rect = rectify_pair(img_l, img_r, F, kp_l, kp_r)
    assert rect.left.shape == rect.right.shape
    assert rect.left.shape[:2] == rect.canvas
    # rectified matches still row-aligned
    dy = np.abs(np.asarray(rect.matches_left)[1] - np.asarray(rect.matches_right)[1])
    assert np.median(dy) < 1.5

    # back-warp roundtrip: a smooth disparity field warped to the original
    # frame keeps values (NN resampling, interior)
    disp_rect = jnp.asarray(
        np.tile(np.linspace(10, 50, rect.canvas[1], dtype=np.float32), (rect.canvas[0], 1))
    )
    back = disparity_to_original_frame(disp_rect, rect.homographies.H_right, (h, w))
    assert back.shape == (h, w)
    vals = np.asarray(back)
    assert np.isfinite(vals).all()
    assert (vals >= 0).all() and (vals <= 50.0).all()


def test_warp_band_matches_gather_bilinear(rng):
    """The gather-free band warp is exact bilinear: it must agree with the
    general gather warp to float tolerance for any homography within its
    band budget (ops/warp.py warp_band)."""
    from stereo_reconstruction.ops.warp import band_budget, warp_band

    img = rng.uniform(0, 255, (60, 80, 3)).astype(np.float32)
    H = np.array([[1.02, 0.03, -2.5], [-0.02, 0.99, 3.2], [4e-5, -3e-5, 1.0]])
    out = (64, 96)                      # canvas larger than the source
    budget = band_budget(H, out, img.shape[:2])
    assert budget is not None
    want = np.asarray(warp_perspective(
        jnp.asarray(img), jnp.asarray(H, np.float32), out))
    got = np.asarray(warp_band(
        jnp.asarray(img), jnp.asarray(H, np.float32), out, *budget))
    assert np.abs(want - got).max() < 1e-3, np.abs(want - got).max()


def test_warp_band_matches_gather_nearest(rng):
    from stereo_reconstruction.ops.warp import band_budget, warp_band

    img = rng.uniform(0, 100, (50, 70)).astype(np.float32)
    H = np.array([[0.98, 0.04, 4.0], [0.01, 1.03, -3.0], [0.0, 0.0, 1.0]])
    out = (60, 80)
    budget = band_budget(H, out, img.shape)
    assert budget is not None
    want = np.asarray(warp_perspective(
        jnp.asarray(img), jnp.asarray(H, np.float32), out, method="nearest"))
    got = np.asarray(warp_band(
        jnp.asarray(img), jnp.asarray(H, np.float32), out, *budget,
        method="nearest"))
    assert np.array_equal(want, got)


def test_band_budget_rejects_large_displacement():
    from stereo_reconstruction.ops.warp import band_budget

    H = np.array([[1.0, 0.0, 300.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    # a 300-px shift of a source that stays visible exceeds every class
    assert band_budget(H, (100, 400), (100, 400)) is None


def _sampled_band_budget(H, out_shape, src_shape, classes=(2, 4, 8, 16, 32, 64)):
    """The round-3 9x9 SAMPLED budget estimator, kept here as the foil for
    the certified version (ops/warp.py band_budget): it can miss a live
    displacement extremum that falls between its samples."""
    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    h_out, w_out = out_shape
    ys = np.linspace(0, h_out - 1, 9)
    xs = np.linspace(0, w_out - 1, 9)
    gx, gy = np.meshgrid(xs, ys)
    den = Hinv[2, 0] * gx + Hinv[2, 1] * gy + Hinv[2, 2]
    den = np.where(np.abs(den) < 1e-12, 1e-12, den)
    sx = (Hinv[0, 0] * gx + Hinv[0, 1] * gy + Hinv[0, 2]) / den
    sy = (Hinv[1, 0] * gx + Hinv[1, 1] * gy + Hinv[1, 2]) / den
    hs, ws = src_shape[:2]
    live = (sx > -1) & (sx < ws) & (sy > -1) & (sy < hs)
    if not live.any():
        return classes[0], classes[0]
    dy = np.abs(sy - gy)[live].max()
    dx = np.abs(sx - gx)[live].max()
    dy_c = next((c for c in classes if c >= dy + 1.5), None)
    dx_c = next((c for c in classes if c >= dx + 1.5), None)
    if dy_c is None or dx_c is None:
        return None
    return dy_c, dx_c


def _live_displacement(Hinv, out_shape, src_shape):
    """True per-pixel live displacement maxima over the FULL integer grid."""
    h_out, w_out = out_shape
    hs, ws = src_shape[:2]
    gx, gy = np.meshgrid(np.arange(w_out, dtype=np.float64),
                         np.arange(h_out, dtype=np.float64))
    den = Hinv[2, 0] * gx + Hinv[2, 1] * gy + Hinv[2, 2]
    safe = np.where(np.abs(den) < 1e-12, 1e-12, den)
    sx = (Hinv[0, 0] * gx + Hinv[0, 1] * gy + Hinv[0, 2]) / safe
    sy = (Hinv[1, 0] * gx + Hinv[1, 1] * gy + Hinv[1, 2]) / safe
    live = (sx > -1) & (sx < ws) & (sy > -1) & (sy < hs)
    if not live.any():
        return 0.0, 0.0, live
    return np.abs(sy - gy)[live].max(), np.abs(sx - gx)[live].max(), live


def test_band_budget_adversarial_pole_sliver():
    """Adversarial H the 9x9 SAMPLING underestimates (VERDICT r3 item 8).

    The Moebius denominator's zero line crosses the canvas diagonally;
    beyond the pole a thin sliver of destination pixels maps BACK into
    the source (live, displacement ~320 px) threaded between the 9x9
    sample points, while every sampled point is dead. The r3 estimator
    returns the smallest class (2, 2) -> warp_band silently zeros the
    sliver; the certified estimator must detect the pole and return None
    (gather fallback)."""
    from stereo_reconstruction.ops.warp import band_budget, warp_band

    out_shape = src_shape = (100, 400)
    # den = 1 - x/380 - y/95 (pole line x + 4y = 380);
    # num_x = 50*den + 10*(x - 374)  -> sx ~ 50 inside a ~14-px-wide strip
    #                                   around x = 374 (between samples
    #                                   349.125 and 399), dead elsewhere
    # num_y = 31*den + 2*(y - 31)    -> sy stays in range over the strip
    Hinv = np.array([
        [10.0 - 50.0 / 380.0, -50.0 / 95.0, 50.0 - 3740.0],
        [-31.0 / 380.0, 2.0 - 31.0 / 95.0, -31.0 - 62.0 + 31.0],
        [-1.0 / 380.0, -1.0 / 95.0, 1.0],
    ])
    H = np.linalg.inv(Hinv)

    dy_true, dx_true, live = _live_displacement(Hinv, out_shape, src_shape)
    assert live.any(), "construction broken: no live sliver"
    assert dx_true > 100.0, dx_true          # huge true displacement...
    sampled = _sampled_band_budget(H, out_shape, src_shape)
    assert sampled == (2, 2), sampled        # ...invisible to the sampler
    assert band_budget(H, out_shape, src_shape) is None  # certified: pole

    # end-to-end: the gather warp lights up the sliver; the band warp
    # under the sampled budget silently zeros it
    ones = jnp.ones(src_shape, jnp.float32)
    Hf = jnp.asarray(H, jnp.float32)
    gather = np.asarray(warp_perspective(ones, Hf, out_shape))
    banded = np.asarray(warp_band(ones, Hf, out_shape, *sampled))
    sliver = (gather > 0.5) & (banded == 0.0)
    assert sliver.sum() > 50, sliver.sum()


def test_band_budget_certified_soundness_fuzz(rng):
    """For random in-budget homographies the certified class must cover
    the true full-grid live displacement with >= 1 px of tap margin."""
    from stereo_reconstruction.ops.warp import band_budget

    out_shape, src_shape = (80, 120), (70, 110)
    n_checked = 0
    for _ in range(60):
        P = np.eye(3)
        P[:2, :2] += rng.uniform(-0.05, 0.05, (2, 2))
        P[:2, 2] = rng.uniform(-10, 10, 2)
        P[2, :2] = rng.uniform(-2e-4, 2e-4, 2)
        H = np.linalg.inv(P)
        budget = band_budget(H, out_shape, src_shape)
        dy_true, dx_true, live = _live_displacement(P, out_shape, src_shape)
        if budget is None:
            continue
        n_checked += 1
        if live.any():
            assert budget[0] >= dy_true + 1.0, (budget, dy_true)
            assert budget[1] >= dx_true + 1.0, (budget, dx_true)
    assert n_checked >= 20, n_checked        # the fuzz actually exercised it
