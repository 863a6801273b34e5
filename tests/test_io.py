import os

import numpy as np
import pytest

from stereo_reconstruction.io import (
    parse_calib,
    read_image,
    read_pfm,
    write_image,
    write_pfm,
)
from stereo_reconstruction.io.image import disparity_png_roundtrip
from stereo_reconstruction.io.mesh_io import read_off, write_off


def test_pfm_roundtrip_gray(tmp_path, rng):
    img = rng.standard_normal((7, 5)).astype(np.float32)
    path = str(tmp_path / "x.pfm")
    write_pfm(path, img)
    out = read_pfm(path)
    np.testing.assert_array_equal(out, img)


def test_pfm_roundtrip_color(tmp_path, rng):
    img = rng.standard_normal((4, 6, 3)).astype(np.float32)
    path = str(tmp_path / "x.pfm")
    write_pfm(path, img)
    np.testing.assert_array_equal(read_pfm(path), img)


def test_pfm_big_endian(tmp_path):
    # hand-craft a big-endian file
    img = np.arange(6, dtype=">f4").reshape(2, 3)
    path = str(tmp_path / "be.pfm")
    with open(path, "wb") as f:
        f.write(b"Pf\n3 2\n1.0\n")
        f.write(np.flipud(img).tobytes())
    out = read_pfm(path)
    np.testing.assert_array_equal(out, img.astype(np.float32))


def test_pfm_row_order(tmp_path):
    """PFM stores rows bottom-up; reader must return top-down."""
    img = np.array([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
    path = str(tmp_path / "o.pfm")
    write_pfm(path, img)
    with open(path, "rb") as f:
        f.readline(), f.readline(), f.readline()
        raw = np.frombuffer(f.read(), dtype="<f4").reshape(2, 2)
    # first stored row must be the bottom image row
    np.testing.assert_array_equal(raw[0], img[1])


def test_parse_calib_adirondack(middeval_root):
    calib = parse_calib(os.path.join(middeval_root, "trainingH", "Adirondack", "calib.txt"))
    # values from the reference data file (same parse as data_loader.cpp:141-164)
    np.testing.assert_allclose(calib.cam0[0, 0], 2076.037, rtol=1e-6)
    np.testing.assert_allclose(calib.cam0[0, 2], 644.073, rtol=1e-6)
    np.testing.assert_allclose(calib.cam1[0, 2], 750.615, rtol=1e-6)
    assert calib.cam0[2, 2] == 1.0
    assert calib.width == 1436 and calib.height == 992
    assert calib.ndisp == 145
    assert calib.baseline == pytest.approx(176.252)


def test_parse_calib_text():
    text = "cam0=[1 0 2; 0 3 4; 0 0 1]\ncam1=[5 0 6; 0 7 8; 0 0 1]\nndisp=64\n"
    calib = parse_calib(text)
    assert calib.cam0[1, 1] == 3.0
    assert calib.cam1[0, 2] == 6.0
    assert calib.ndisp == 64


def test_image_roundtrip(tmp_path, rng):
    img = rng.integers(0, 255, (5, 4, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_image(path, img)
    np.testing.assert_array_equal(read_image(path), img)


def test_disparity_png_roundtrip_quantizes():
    disp = np.array([[1.4, 2.6, -3.0, 300.0]])
    out = disparity_png_roundtrip(disp)
    np.testing.assert_array_equal(out, [[1.0, 3.0, 0.0, 255.0]])


def test_off_roundtrip(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [np.inf, 0, 0]], dtype=np.float64)
    col = np.array([[255, 0, 0, 255]] * 4, dtype=np.uint8)
    tri = np.array([[0, 1, 2]])
    path = str(tmp_path / "m.off")
    write_off(path, pos, col, tri)
    v, c, f = read_off(path)
    assert len(v) == 4 and len(f) == 1
    np.testing.assert_array_equal(v[3], [0, 0, 0])  # invalid vertex written as 0 0 0
    np.testing.assert_array_equal(f[0], [0, 1, 2])
