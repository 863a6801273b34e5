"""Batched end-to-end pipeline (pipeline_batch.py, VERDICT r2 item 2).

The reference main() runs one scene at a time (src/main.cpp:13-66); the
batched runner pushes B pairs through two device programs. These tests
pin correctness on real data: quality vs GT, per-pair failure masking
inside the batch, and identity-fallback behavior.
"""

import dataclasses

import numpy as np
import pytest

from stereo_reconstruction.config import MatcherConfig, PipelineConfig, ReconConfig
from stereo_reconstruction.pipeline_batch import run_batch


@pytest.fixture(scope="module")
def teddy_ds2(middeval_root):
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair

    return downsample_pair(downsample_pair(MiddEval3(middeval_root).load_training(13)))


@pytest.fixture(scope="module")
def cfg():
    base = PipelineConfig()
    return base.replace(
        matcher=MatcherConfig(block_size=17, max_disparity=64),
        recon=dataclasses.replace(base.recon, outlier_kernel=101),
    )


@pytest.mark.slow
def test_batch_quality_on_real_pairs(teddy_ds2, cfg):
    res = run_batch([teddy_ds2, teddy_ds2], cfg)
    assert res.disparity.shape[0] == 2
    for i in range(2):
        assert res.pose_ok[i], res.metrics[i]
        assert res.metrics[i]["bad_percent"] < 25.0, res.metrics[i]
    assert res.timings["pose"] > 0 and res.timings["dense"] > 0


def test_batch_failure_masking(teddy_ds2, cfg):
    black = dataclasses.replace(
        teddy_ds2,
        image_left=np.zeros_like(np.asarray(teddy_ds2.image_left)),
        image_right=np.zeros_like(np.asarray(teddy_ds2.image_right)),
        disp_right_gt=None, mask_right_nocc=None,
        disp_left_gt=None, mask_left_nocc=None,
    )
    res = run_batch([teddy_ds2, black], cfg)
    assert res.pose_ok[0] and not res.pose_ok[1]
    # black pixels are forced to disparity 0 (reference black-skip)
    assert float(np.abs(res.disparity[1]).max()) == 0.0
    # the good pair is unaffected by its failed batchmate
    assert res.metrics[0]["bad_percent"] < 25.0


@pytest.mark.slow
def test_batch_sharded_over_data_mesh(teddy_ds2, cfg):
    """The batched pipeline SPMD-partitions over a ('data',) mesh: same
    outputs as the unsharded batch (both device programs are pure vmaps
    over independent pairs) up to SPMD reduction-order float noise."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from stereo_reconstruction.parallel import make_mesh

    mesh = make_mesh(data=2, tile=1, devices=jax.devices()[:2])
    res_m = run_batch([teddy_ds2, teddy_ds2], cfg, mesh=mesh)
    res_s = run_batch([teddy_ds2, teddy_ds2], cfg)
    # SPMD partitioning reassociates conv/matmul reductions, so a handful
    # of descriptor/argmin ties can flip — require near-identity
    mismatch = float((res_m.disparity != res_s.disparity).mean())
    assert mismatch < 1e-3, f"{mismatch:.2%} pixels differ"
    assert res_m.pose_ok.all()


@pytest.mark.slow
def test_run_batches_pipelined_matches_run_batch(teddy_ds2, cfg):
    """The software-pipelined multi-batch runner must produce the same
    results as sequential run_batch calls with fold_in(key, i) keys."""
    import jax

    from stereo_reconstruction.pipeline_batch import run_batches

    batches = [[teddy_ds2], [teddy_ds2, teddy_ds2]]
    piped = run_batches(batches, cfg, fetch_depth=False)
    key = jax.random.key(cfg.seed)
    for i, batch in enumerate(batches):
        seq = run_batch(batch, cfg, key=jax.random.fold_in(key, i))
        assert np.array_equal(piped[i].disparity, seq.disparity)
        assert piped[i].depth is None and seq.depth is not None
        for m_p, m_s in zip(piped[i].metrics, seq.metrics):
            assert m_p["bad_percent"] == m_s["bad_percent"]


def test_sticky_band_monotone():
    """The static warp-band class must grow monotonically per key: every
    distinct class is a full device recompile of _dense_batch, and
    per-batch pose jitter flips adjacent classes."""
    from stereo_reconstruction.pipeline_batch import _sticky_band

    k = ("test-sticky", 1)
    # first insertion bumps one class up per axis (jitter headroom)
    assert _sticky_band(k, (2, 4)) == (4, 8)
    assert _sticky_band(k, (4, 2)) == (4, 8)     # inside the bumped band
    assert _sticky_band(k, None) is None         # gather fallback passthrough
    assert _sticky_band(k, (8, 2)) == (8, 8)     # genuine growth still works
    assert _sticky_band(k, (2, 2)) == (8, 8)     # never shrinks
    assert _sticky_band(("other", 2), (64, 64)) == (64, 64)  # top class capped
