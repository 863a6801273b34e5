"""Native C++ IO runtime vs pure-Python codecs (byte-identical)."""

import os

import numpy as np
import pytest

from stereo_reconstruction.io import native
from stereo_reconstruction.io.image import read_image, write_image
from stereo_reconstruction.io.pfm import read_pfm as py_read_pfm, write_pfm as py_write_pfm

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libstereo_io.so not built (make -C native)"
)


def test_png_matches_pil(tmp_path, rng):
    img = rng.integers(0, 255, (37, 53, 3), np.uint8)
    path = str(tmp_path / "x.png")
    write_image(path, img)
    np.testing.assert_array_equal(native.read_png(path), img)


def test_png_gray_conversion(tmp_path, rng):
    img = rng.integers(0, 255, (21, 33, 3), np.uint8)
    path = str(tmp_path / "x.png")
    write_image(path, img)
    got = native.read_png(path, channels=1)
    want = read_image(path, grayscale=True)
    # both use BT.601; rounding may differ by 1
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_png_real_data(middeval_root):
    p = os.path.join(middeval_root, "trainingH", "Adirondack", "im0.png")
    from PIL import Image

    with Image.open(p) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(native.read_png(p), want)


def test_pfm_roundtrip_both_ways(tmp_path, rng):
    x = rng.standard_normal((19, 23)).astype(np.float32)
    pn = str(tmp_path / "n.pfm")
    pp = str(tmp_path / "p.pfm")
    native.write_pfm(pn, x)
    np.testing.assert_array_equal(py_read_pfm(pn), x)
    py_write_pfm(pp, x)
    np.testing.assert_array_equal(native.read_pfm(pp), x)


def test_batch_reader(tmp_path, rng):
    paths = []
    imgs = []
    for i in range(6):
        img = rng.integers(0, 255, (16, 24, 3), np.uint8)
        p = str(tmp_path / f"{i}.png")
        write_image(p, img)
        paths.append(p)
        imgs.append(img)
    batch = native.read_png_batch(paths, 16, 24, 3, num_threads=3)
    np.testing.assert_array_equal(batch, np.stack(imgs))


def test_bad_path_raises():
    with pytest.raises((IOError, OSError)):
        native.read_png("/nonexistent/file.png")
