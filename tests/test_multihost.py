"""Gate on the recorded TRUE multi-process scaling report (MULTIHOST.json).

Produced by ``tools/multihost_bench.py``: 2 core-pinned CPU processes
joined with ``jax.distributed`` (Gloo collectives — the CPU stand-in for
NCCL), running the production sharded entry points unchanged. This is
the "2+ hosts" leg of the north-star scaling target; SCALING.json covers
the single-process virtual-mesh leg. Regenerate with:

    PYTHONPATH= python tools/multihost_bench.py
"""

import json
import os

import pytest

PATH = os.path.join(os.path.dirname(__file__), "..", "MULTIHOST.json")


@pytest.fixture(scope="module")
def report():
    if not os.path.exists(PATH):
        pytest.skip("MULTIHOST.json not generated "
                    "(run tools/multihost_bench.py)")
    with open(PATH) as f:
        data = json.load(f)
    from conftest import warn_if_stale_baseline

    warn_if_stale_baseline(data, "MULTIHOST.json")
    return data


def test_weak_scaling_efficiency(report):
    eff = report["efficiency"]
    # north star: >= 80% at 2+ hosts
    assert eff["matcher_data_weak"] >= 0.8, eff
    # ba_weak is the PRODUCTION pattern (B pairs' LMs share each
    # iteration's fused psum, parallel/ba_dist.py
    # distributed_bundle_adjust_batch) — gated at the north star
    assert eff["ba_weak"] >= 0.8, eff


def test_tile_strong_scaling(report):
    # structural ceiling ~0.89 at these shapes (smoothing warm-up rows are
    # genuine extra work per tile; see tools/multihost_bench.py docstring)
    assert report["efficiency"]["matcher_tile_strong"] >= 0.6, report["efficiency"]


def test_cross_process_correctness(report):
    c = report["correctness"]
    # ppermute halos across process boundaries: gathered sharded disparity
    # agrees with the single-device matcher (warm-up truncation only)
    assert c["tile_agreement_vs_single_device"] >= 0.995, c
    # wavefront-exact mode must be BIT-IDENTICAL across processes
    assert c["tile_agreement_exact"] == 1.0, c
    # psum'd Middlebury metric == locally computed metric
    assert c["evaldisp_psum_abs_diff"] < 1e-3, c
    # the distributed LMs actually optimized
    assert c["ba_cost_ratio"] < 0.1, c
    assert c["ba_batch_cost_ratio"] < 0.1, c


def test_it_was_really_multiprocess(report):
    assert report["processes"] >= 2
    assert "gloo" in report["backend"]


def test_oversubscribed_groups(report):
    """Groups with more processes than physical cores (e.g. 4 procs on 2
    cores): collectives must stay CORRECT, and weak scaling must reach
    >= 80% of the time-slicing ceiling (cores/n) — the honest analog of
    the >=0.8 target when each process cannot have its own core."""
    for n in report.get("group_sizes", []):
        ck = f"correctness_{n}proc"
        ek = f"efficiency_{n}proc"
        if ck not in report:
            continue
        c = report[ck]
        # each extra tile adds a smoothing warm-up boundary, so the
        # truncation disagreement grows with n (0.998 at 2 tiles, 0.992
        # at 4 on this workload) — and the wavefront-exact mode closes it
        # to bit-identity at every n (VERDICT r3 item 6)
        assert c["tile_agreement_vs_single_device"] >= 0.99, (n, c)
        assert c["tile_agreement_exact"] == 1.0, (n, c)
        assert c["evaldisp_psum_abs_diff"] < 1e-3, (n, c)
        assert c["ba_cost_ratio"] < 0.1, (n, c)
        e = report[ek]
        assert e["matcher_data_weak"] >= 0.8 * e["core_ceiling"], (n, e)
        # production-pattern BA (B pairs per fused psum) restores the 0.8
        # north-star margin even oversubscribed (VERDICT r3 item 7); the
        # single-problem chain stays recorded as the worst case (0.71 of
        # ceiling at 4 procs / 2 cores: one context switch per psum)
        assert e["ba_weak"] >= 0.8 * e["core_ceiling"], (n, e)
        assert e["ba_single_weak"] >= 0.6 * e["core_ceiling"], (n, e)
