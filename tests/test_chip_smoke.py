"""chip_smoke.py's phases on the CPU at small shapes (the kernel in the
Pallas interpreter, the four-card phases on virtual devices), and its
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from stereo_reconstruction.data.synthetic import make_scene

H, W, D = 188, 225, 50


@pytest.fixture(scope="module")
def scenes():
    return cs.render([1, 2, 3, 4], H, W, D)


@pytest.fixture(scope="module")
def flat():
    (scene,) = cs.render([0], H, W, D, rectified=True)
    return scene


def test_main_refuses_a_host_without_gpu(capsys):
    with pytest.raises(cs.SmokeFailure, match="needs GPUs"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails_without_the_package(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_phase_kernel_interpreted(flat):
    rec = cs.phase_kernel(flat.pair.image_left[:40], flat.pair.image_right[:40],
                          24, interpret=True)
    assert rec["bit_equal"] and rec["kernel_ms"] > 0 and rec["plain_ms"] > 0


def test_phase_matcher(flat):
    rec = cs.phase_matcher(flat, D, band_rows=24)
    assert rec["oracle_agreement"] >= cs.MIN_ORACLE_AGREEMENT
    assert rec["bad2_percent_vs_truth"] <= cs.MAX_BAD2_PERCENT
    assert rec["kernel"] is False                      # no GPU here


def test_phase_run_pair(scenes):
    rec = cs.phase_run_pair(scenes[0], cs.pipeline_config(D))
    assert rec["bad2_percent_vs_truth"] <= cs.MAX_BAD2_PERCENT
    assert rec["mesh_vertices"] > 0
    assert set(rec["warm_stage_s"]) == {"pose", "rectify", "disparity", "recon"}


def test_phase_multi_batch_on_four_virtual_devices(scenes):
    rec = cs.phase_multi_batch(scenes, cs.pipeline_config(D), data=4)
    assert rec["sharded"]["mesh"] == {"data": 4, "tile": 1}
    assert 0.0 < rec["disparity_equal_share"] <= 1.0
    assert len(rec["single"]["bad2_percent_vs_truth"]) == 4


def test_phase_multi_tile_on_four_virtual_devices(flat):
    rec = cs.phase_multi_tile(flat, D, tiles=4)
    assert rec["bit_equal"] and rec["shape"] == [192, W]


def test_phase_multi_tile_with_interpreted_kernel(monkeypatch):
    """The four-card tile phase on the fused kernel's path (interpreted)."""
    import functools

    monkeypatch.setattr(cs, "MatcherConfig",
                        functools.partial(cs.MatcherConfig, backend="pallas"))
    small = make_scene(0, 64, 96, 16, rectified=True)
    rec = cs.phase_multi_tile(small, 16, tiles=4, interpret=True)
    assert rec["bit_equal"]


def test_smoke_sizes_are_the_reference_operating_point():
    assert (cs.HEIGHT, cs.WIDTH, cs.MAX_DISPARITY) == (750, 900, 200)
    assert (cs.BLOCK, cs.SMOOTH, cs.BATCH) == (17, 0.9, 8)
    scene = make_scene(5, 32, 48, 16)
    assert scene.pair.ndisp == 16
