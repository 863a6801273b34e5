"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The reference cannot be tested this way (no parallelism exists there);
these are the framework's own guarantees: sharded results match the
single-device path (SURVEY.md §4c).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.config import BundleAdjustmentConfig, MatcherConfig
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.ops.block_search import block_search_right
from stereo_reconstruction.ops.metrics import evaldisp
from stereo_reconstruction.parallel import (
    distributed_bundle_adjust,
    make_mesh,
    sharded_block_search_right,
    sharded_evaldisp,
)
from stereo_reconstruction.pose.ba import bundle_adjust


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, tile=4)


def _pair_batch(rng, b=4, h=64, w=96):
    left = rng.integers(1, 255, (b, h, w, 3)).astype(np.uint8)
    right = np.roll(left, -6, axis=2)
    right[:, :, :2] = 0
    return jnp.asarray(left), jnp.asarray(right)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_block_search_matches_single_device(rng, mesh, backend):
    """Both matcher backends under the tile axis: the fused kernel
    (global-row-coordinate mode, in the Pallas interpreter here) must
    shard as exactly as the plain XLA path."""
    left, right = _pair_batch(rng)
    cfg = MatcherConfig(block_size=5, min_disparity=0, max_disparity=16,
                        row_smooth_iters=1, backend=backend)
    sharded = np.asarray(sharded_block_search_right(
        left, right, mesh, cfg, interpret=backend == "pallas"))

    # single-device reference on the XLA path (the fused kernel agrees
    # with it bit-for-bit on integer-valued images)
    cfg_s = MatcherConfig(block_size=5, min_disparity=0, max_disparity=16,
                          row_smooth_iters=1, backend="xla")
    single = np.stack(
        [np.asarray(block_search_right(left[i], right[i], cfg_s)) for i in range(left.shape[0])]
    )
    # global-coordinate window geometry makes the cost volume exact per
    # tile; the smoothing warm-up covers the whole chain at this tile size
    # -> bit-identical output
    np.testing.assert_array_equal(sharded, single)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_exact_wavefront_bitwise(rng, mesh, backend):
    """exact=True (wavefront reseeding, VERDICT r3 item 6): the sharded
    matcher must be BIT-IDENTICAL to the single-device result with no
    warmup truncation at all — the up-neighbor chain crosses every tile
    boundary through the ppermuted seed rows."""
    left, right = _pair_batch(rng, b=2, h=96, w=96)
    cfg = MatcherConfig(block_size=5, min_disparity=0, max_disparity=16,
                        row_smooth_iters=1, backend=backend)
    sharded = np.asarray(sharded_block_search_right(
        left, right, mesh, cfg, exact=True, interpret=backend == "pallas"))
    cfg_s = MatcherConfig(block_size=5, min_disparity=0, max_disparity=16,
                          row_smooth_iters=1, backend="xla")
    single = np.stack([
        np.asarray(block_search_right(left[i], right[i], cfg_s))
        for i in range(left.shape[0])
    ])
    np.testing.assert_array_equal(sharded, single)


@pytest.mark.slow
def test_sharded_quality_budget_real_pair(rng, mesh, middeval_root):
    """bad-2.0 budget on a real pair (VERDICT round-1 item 5): the sharded
    matcher must stay within 0.5pp of the single-device result on Teddy,
    scored with the single-device output as ground truth."""
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair

    pair = downsample_pair(MiddEval3(middeval_root).load_training(13))
    L = np.asarray(pair.image_left, np.uint8)[:368, :448]
    R = np.asarray(pair.image_right, np.uint8)[:368, :448]
    cfg = MatcherConfig(block_size=17, min_disparity=0, max_disparity=64,
                        smooth_factor=0.9)
    lb = jnp.asarray(np.stack([L] * 2))
    rb = jnp.asarray(np.stack([R] * 2))
    sharded = np.asarray(sharded_block_search_right(lb, rb, mesh, cfg))[0]
    single = np.asarray(block_search_right(jnp.asarray(L), jnp.asarray(R), cfg))

    m = evaldisp(
        jnp.asarray(sharded), jnp.asarray(single),
        jnp.full(single.shape, 255, jnp.uint8), bad_thresh=2.0,
    )
    bad2 = float(m["bad_percent"])
    agree = (sharded == single).mean()
    assert bad2 <= 0.5, f"sharded bad-2.0 vs single = {bad2:.3f}pp"
    assert agree > 0.995, f"exact agreement only {agree:.4%}"


def test_sharded_evaldisp_matches_single(rng, mesh):
    b, h, w = 4, 64, 96
    disp = jnp.asarray(rng.uniform(0, 20, (b, h, w)).astype(np.float32))
    gt = jnp.asarray(rng.uniform(0, 20, (b, h, w)).astype(np.float32))
    mask = jnp.asarray(
        np.where(rng.random((b, h, w)) < 0.8, 255, 0).astype(np.uint8)
    )
    got = sharded_evaldisp(disp, gt, mask, mesh, bad_thresh=2.0, max_disp=32.0)

    # single-device: accumulate the same statistics over the whole batch
    n = nv = bad = 0
    serr = 0.0
    for i in range(b):
        m = evaldisp(disp[i], gt[i], mask[i], bad_thresh=2.0, max_disp=32.0)
        n += int(m["n_evaluated"])
        inv = float(m["invalid_percent"]) * int(m["n_evaluated"]) / 100.0
        nv += int(m["n_evaluated"]) - int(round(inv))
        bad += int(round(float(m["bad_percent"]) * int(m["n_evaluated"]) / 100.0))
        serr += float(m["avg_err"]) * (int(m["n_evaluated"]) - int(round(inv)))
    np.testing.assert_allclose(float(got["bad_percent"]), 100.0 * bad / n, atol=0.05)
    np.testing.assert_allclose(float(got["avg_err"]), serr / max(nv, 1), rtol=1e-3)


def test_distributed_ba_matches_single(rng, mesh):
    n_pts = 64
    K = jnp.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]])
    aa = jnp.array([0.03, -0.05, 0.02])
    R = geo.angle_axis_to_rotation(aa)
    T = jnp.array([-0.6, 0.05, 0.2])
    depths = jnp.asarray(rng.uniform(4, 9, n_pts).astype(np.float32))
    xl = jnp.concatenate(
        [jnp.asarray(rng.uniform(-0.25, 0.25, (2, n_pts)).astype(np.float32)),
         jnp.ones((1, n_pts))]
    )
    pts = xl * depths[None, :]
    pts_r = geo.transform(R, T, pts)
    kp_l = geo.project(K, pts)
    kp_r = geo.project(K, pts_r)

    cfg = BundleAdjustmentConfig(max_iterations=10)
    init_R = geo.angle_axis_to_rotation(aa + 0.03)
    init_T = T + 0.05

    res_d = distributed_bundle_adjust(
        kp_l, kp_r, K, K, init_R, init_T, pts, mesh, config=cfg
    )
    res_s = bundle_adjust(kp_l, kp_r, K, K, init_R, init_T, pts, config=cfg)

    # psum reduction order differs from the single-device sum in f32, so
    # LM accept/reject trajectories can diverge slightly on this
    # gauge-free two-view problem; both must land on the same pose
    np.testing.assert_allclose(
        np.asarray(res_d.rotation), np.asarray(res_s.rotation), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_d.translation), np.asarray(res_s.translation), atol=5e-3
    )
    np.testing.assert_allclose(
        float(res_d.final_cost), float(res_s.final_cost), rtol=0.05, atol=1e-3
    )


def test_distributed_ba_batch_matches_per_pair(rng, mesh):
    """B independent problems through the vmapped fused-psum LM must
    match B separate distributed_bundle_adjust calls (VERDICT r3 item 7:
    the amortized-collective production pattern is a pure batching)."""
    from stereo_reconstruction.parallel import (
        distributed_bundle_adjust_batch,
    )

    B, n_pts = 3, 64
    K = jnp.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]])
    cfg = BundleAdjustmentConfig(max_iterations=8)
    kpls, kprs, ptss, R0s, T0s = [], [], [], [], []
    for i in range(B):
        aa = jnp.array([0.03, -0.05, 0.02]) * (1.0 + 0.3 * i)
        R = geo.angle_axis_to_rotation(aa)
        T = jnp.array([-0.6, 0.05, 0.2]) + 0.1 * i
        depths = jnp.asarray(rng.uniform(4, 9, n_pts).astype(np.float32))
        xl = jnp.concatenate(
            [jnp.asarray(
                rng.uniform(-0.25, 0.25, (2, n_pts)).astype(np.float32)),
             jnp.ones((1, n_pts))])
        pts = xl * depths[None, :]
        kpls.append(geo.project(K, pts))
        kprs.append(geo.project(K, geo.transform(R, T, pts)))
        ptss.append(pts)
        R0s.append(geo.angle_axis_to_rotation(aa + 0.03))
        T0s.append(T + 0.05)

    poses, F, c0, cf, X = distributed_bundle_adjust_batch(
        jnp.stack(kpls), jnp.stack(kprs), K, K,
        jnp.stack(R0s), jnp.stack(T0s), jnp.stack(ptss), mesh, config=cfg)

    for i in range(B):
        res_i = distributed_bundle_adjust(
            kpls[i], kprs[i], K, K, R0s[i], T0s[i], ptss[i], mesh,
            config=cfg)
        # vmapped einsum reassociation differs from the single-pair
        # contraction in f32, so LM accept trajectories can diverge a
        # step (same tolerance rationale as
        # test_distributed_ba_matches_single)
        np.testing.assert_allclose(np.asarray(poses[i]),
                                   np.asarray(res_i.pose), atol=2e-3)
        np.testing.assert_allclose(float(cf[i]), float(res_i.final_cost),
                                   rtol=0.05, atol=1e-4)
        assert float(cf[i]) < 0.05 * float(c0[i])
