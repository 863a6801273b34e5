"""Per-pair failure masking — host batches and device batches.

The reference aborts on any failure (``throw std::runtime_error``,
pose_estimation.cpp:84 among others); the framework instead masks the
failed pair and keeps the batch alive (SURVEY.md §5 "Failure detection /
recovery"): host-level exceptions via utils.batch.run_batch, device-level
degeneracy via the traced ``valid`` flag of PoseEstimate — which also
composes under vmap, so one bad pair inside a vmapped device batch
flags only itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import (
    BundleAdjustmentConfig,
    PipelineConfig,
    RansacConfig,
)
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.pose.pipeline import estimate_pose_from_matches
from stereo_reconstruction.utils.batch import aggregate_metrics, run_batch


@dataclasses.dataclass
class _FakePair:
    name: str


@dataclasses.dataclass
class _FakeResult:
    metrics: dict


def test_run_batch_masks_host_failures(tmp_path):
    pairs = [_FakePair("a"), _FakePair("boom"), _FakePair("c")]

    def fn(pair):
        if pair.name == "boom":
            raise RuntimeError("synthetic per-pair failure")
        return _FakeResult(metrics={"bad_percent": 10.0})

    path = str(tmp_path / "metrics.jsonl")
    outcomes = run_batch(pairs, fn, metrics_path=path)

    assert [o.ok for o in outcomes] == [True, False, True]
    assert "RuntimeError" in outcomes[1].error
    agg = aggregate_metrics(outcomes)
    assert agg["num_ok"] == 2 and agg["num_failed"] == 1
    assert agg["bad_percent"] == pytest.approx(10.0)
    assert len(open(path).read().strip().splitlines()) == 3


def _synthetic_matches(rng, n, noise=0.0):
    """Matches consistent with a known two-view geometry."""
    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]])
    aa = jnp.array([0.03, -0.02, 0.01])
    R = geo.angle_axis_to_rotation(aa)
    T = jnp.array([-1.0, 0.05, 0.1])
    depths = rng.uniform(4, 9, n).astype(np.float32)
    xl = np.concatenate(
        [rng.uniform(-0.3, 0.3, (2, n)).astype(np.float32),
         np.ones((1, n), np.float32)]
    )
    pts = jnp.asarray(xl * depths[None, :])
    kp_l = geo.project(jnp.asarray(K), pts)
    kp_r = geo.project(jnp.asarray(K), geo.transform(R, T, pts))
    if noise:
        kp_l = kp_l.at[:2].add(noise * rng.standard_normal((2, n)))
        kp_r = kp_r.at[:2].add(noise * rng.standard_normal((2, n)))
    return np.asarray(kp_l), np.asarray(kp_r), K


def test_vmapped_pose_batch_masks_degenerate_pair():
    """One degenerate element inside a vmapped device batch flags only
    itself — the in-batch analog of the reference's process-killing
    throw on <8 usable matches (eight_point.cpp:182-184)."""
    rng = np.random.default_rng(3)
    n = 64
    kl, kr, K = _synthetic_matches(rng, n, noise=0.1)

    config = PipelineConfig(
        ransac=RansacConfig(num_hypotheses=32),
        ba=BundleAdjustmentConfig(max_iterations=4, num_points=24),
    )

    # batch of 2: element 0 has plenty of valid matches, element 1 has
    # only 5 (below the 12-point sample support) — a degenerate pair
    batch_kl = jnp.stack([jnp.asarray(kl), jnp.asarray(kl)])
    batch_kr = jnp.stack([jnp.asarray(kr), jnp.asarray(kr)])
    n_valid = jnp.array([n, 5])
    keys = jax.random.split(jax.random.key(0), 2)

    fn = jax.vmap(
        lambda key, ml, mr, nv: estimate_pose_from_matches(
            key, ml, mr, jnp.asarray(K), jnp.asarray(K), config,
            num_matches_valid=nv,
        )
    )
    est = fn(keys, batch_kl, batch_kr, n_valid)

    assert bool(est.valid[0]), "healthy pair must stay valid"
    assert not bool(est.valid[1]), "degenerate pair must be masked"
    # the healthy element's solution is unpolluted by its bad neighbor
    assert float(est.reproj_error_ba[0]) < 2.0
    assert bool(est.enough_points[0])
