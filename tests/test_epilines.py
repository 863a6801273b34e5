"""Epipolar-line computation + rasterization.

Covers the reference computeEpiLines/drawEpilines/drawRectifiedEpilines
(rectification.cpp:90-114,558-635).
"""

import numpy as np

from stereo_reconstruction.rectify.epilines import (
    draw_epilines,
    draw_rectified_epilines,
    epipolar_lines,
    epipole,
)

# F of a rectified pair: x'^T F x = 0 with y' = y  =>  F = [e]_x, e = (1,0,0)
F_RECT = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def test_lines_satisfy_correspondence():
    rng = np.random.default_rng(0)
    F = rng.normal(size=(3, 3))
    F = F / np.linalg.norm(F)
    pts = rng.uniform(10, 90, (12, 2))
    lines = epipolar_lines(F, pts, which=1)      # lines in image 2: F x
    hom = np.concatenate([pts, np.ones((12, 1))], axis=1)
    expect = hom @ F.T
    expect /= np.linalg.norm(expect[:, :2], axis=1, keepdims=True)
    # equal up to sign
    s = np.sign(np.sum(lines * expect, axis=1))[:, None]
    np.testing.assert_allclose(lines, expect * s, atol=1e-12)
    # normalization: a^2 + b^2 = 1 (cv::computeCorrespondEpilines)
    np.testing.assert_allclose(np.linalg.norm(lines[:, :2], axis=1), 1.0)


def test_epipole_is_null_vector():
    e = np.array([2.0, 1.0, 1.0])
    F = np.array([[0, -e[2], e[1]], [e[2], 0, -e[0]], [-e[1], e[0], 0]], float)
    n = epipole(F)
    np.testing.assert_allclose(np.abs(n / np.linalg.norm(n)),
                               np.abs(e / np.linalg.norm(e)), atol=1e-12)


def test_rectified_lines_are_horizontal_rows():
    h, w = 48, 64
    left = np.zeros((h, w, 3), np.uint8)
    right = np.zeros((h, w, 3), np.uint8)
    pl = np.array([[10.0, 12.0], [30.0, 25.0], [50.0, 40.0]])
    pr = pl - np.array([4.0, 0.0])               # horizontal disparity only
    out_l, out_r = draw_rectified_epilines(left, right, F_RECT, pl, pr,
                                           num_lines=3)
    # each drawn epiline must be the full-width row of its point
    for img, pts in ((out_l, pl), (out_r, pr)):
        for x, y in pts:
            row = img[int(y)]
            assert (row != 0).any(axis=-1).sum() == img.shape[1]  # full row
        # rows without points stay untouched
        assert (img[0] == 0).all()
    # inputs were not mutated
    assert (left == 0).all() and (right == 0).all()


def test_circles_drawn_at_points():
    h, w = 40, 40
    img = np.zeros((h, w, 3), np.uint8)
    out_l, out_r = draw_epilines(img, img, F_RECT,
                                 np.array([[20.0, 20.0]]),
                                 np.array([[20.0, 20.0]]), num_lines=1)
    # a filled radius-4 disk covers (20, 20) +/- 4 in y
    assert (out_l[16:25, 20] != 0).any(axis=-1).all()
    assert (out_r[16:25, 20] != 0).any(axis=-1).all()


def test_deterministic_colors():
    img = np.zeros((32, 32, 3), np.uint8)
    pl = np.array([[8.0, 8.0], [20.0, 20.0]])
    a = draw_epilines(img, img, F_RECT, pl, pl, seed=7)
    b = draw_epilines(img, img, F_RECT, pl, pl, seed=7)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
