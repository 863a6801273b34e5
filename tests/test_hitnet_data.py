"""Precomputed-disparity (HitNet) data path.

Covers the reference DataLoader's HitNet side (data_loader.cpp:19-29,
127-139,166-203) and the test_reconstruction_HitNet rescale semantics
(test_reconstruction.cpp:103-138).
"""

import os

import numpy as np
import pytest
from PIL import Image

from stereo_reconstruction.data.hitnet import (
    PrecomputedDisparities,
    average_disparity,
    read_grayscale_disparity,
    read_hitnet_disparity,
    rescale_to_gt_mean,
)

REFERENCE_RESULTS = "/root/reference/results/HitNet"


def _make_tree(root, split, scenes):
    for name, value in scenes:
        d = os.path.join(root, split, name)
        os.makedirs(d)
        img = np.full((8, 10), value, np.uint8)
        Image.fromarray(img, "L").convert("RGB").save(
            os.path.join(d, "im0_reference.png")
        )


def test_scan_and_load_sorted(tmp_path):
    root = str(tmp_path)
    _make_tree(root, "trainingH", [("Zebra", 30), ("Adirondack", 10), ("Teddy", 20)])
    _make_tree(root, "testH", [("OnlyOne", 40)])
    pd = PrecomputedDisparities(root)
    # alphabetical ordering, like the reference's std::sort of paths
    assert [os.path.basename(p) for p in pd.training_paths] == [
        "Adirondack", "Teddy", "Zebra",
    ]
    d0 = pd.load_training(0)
    assert d0.dtype == np.float32 and d0.shape == (8, 10)
    assert float(d0[0, 0]) == 10.0
    assert float(pd.load_training(2)[0, 0]) == 30.0
    assert float(pd.load_test(0)[0, 0]) == 40.0
    assert len(pd.load_training_dataset()) == 3


def test_grayscale_reader_roundtrip(tmp_path):
    arr = np.arange(48, dtype=np.uint8).reshape(6, 8)
    p = str(tmp_path / "d.png")
    Image.fromarray(arr, "L").save(p)
    d = read_grayscale_disparity(p)
    assert d.dtype == np.float32
    np.testing.assert_array_equal(d, arr.astype(np.float32))


def test_average_disparity_reference_semantics():
    d = np.array([[1.0, 3.0], [np.inf, -np.inf]], np.float32)
    # only +/-inf excluded (utils.cpp:13)
    assert average_disparity(d) == 2.0
    d2 = np.array([[2.0, -1.0]], np.float32)   # negatives included
    assert average_disparity(d2) == 0.5


def test_rescale_to_gt_mean():
    disp = np.full((4, 4), 2.0, np.float32)
    gt = np.full((4, 4), 6.0, np.float32)
    gt[0, 0] = np.inf                          # invalid GT pixel ignored
    out = rescale_to_gt_mean(disp, gt)
    np.testing.assert_allclose(out, 6.0, rtol=1e-6)
    # degenerate inputs pass through unscaled
    np.testing.assert_array_equal(
        rescale_to_gt_mean(np.zeros((2, 2), np.float32), gt),
        np.zeros((2, 2), np.float32),
    )


@pytest.mark.skipif(
    not os.path.isdir(REFERENCE_RESULTS), reason="HitNet artifacts not available"
)
def test_real_hitnet_reconstruction(middeval_root):
    """Full RUN_ALL=0 flow on real artifacts: HitNet disparity -> GT-mean
    rescale -> depth -> mesh grid (test_reconstruction.cpp:103-138)."""
    from stereo_reconstruction.config import PipelineConfig, ReconConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.pipeline import reconstruct_from_disparity

    ds = MiddEval3(middeval_root)
    pd = PrecomputedDisparities(REFERENCE_RESULTS)
    pair = ds.load_training(13)                # Teddy (scenarioIdx 13)
    disp = pd.load_training(13)
    assert disp.shape[0] > 100

    if pair.disp_left_gt is not None:
        disp = rescale_to_gt_mean(disp, pair.disp_left_gt)

    # small crop keeps the CPU test fast; outlier kernel shrunk to fit
    import dataclasses
    crop = 96
    pair = dataclasses.replace(
        pair,
        image_right=np.asarray(pair.image_right)[:crop, :crop],
        image_left=np.asarray(pair.image_left)[:crop, :crop],
    )
    cfg = PipelineConfig(recon=ReconConfig(outlier_kernel=31))
    grid, depth = reconstruct_from_disparity(pair, disp[:crop, :crop], cfg)
    assert depth.shape == (crop, crop)
    assert np.isfinite(depth[depth > 0]).all()
