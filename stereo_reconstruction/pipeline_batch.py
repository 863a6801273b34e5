"""Batched end-to-end pipeline: B pairs as two device programs.

``run_pair`` (pipeline.py) reproduces the reference ``main()`` flow
(src/main.cpp:13-66) one pair at a time with a host round-trip per
stage, so the pipeline around the matcher is host-bound. This module
batches the whole flow over B pairs:

  device program 1  (_pose_batch):   vmapped sparse-pose stage
                                     (SIFT x2 -> match -> RANSAC -> BA)
  host              (tiny f64 math): Loop-Zhang homographies per pair
                                     (3x3 matrices; microseconds each)
  device program 2  (_dense_batch):  vmapped warp -> dense matcher ->
                                     disparity back-warp -> outlier clamp
                                     -> depth

Two host->device round-trips per BATCH instead of four per PAIR, and
every stage runs at batch width.

Transfers are kept small: images upload in their smallest EXACT dtype
(uint8/f16), disparities download as exact int16, depth only on request,
and ``run_batches`` software-pipelines consecutive batches so batch i+1's
upload+pose overlap batch i's host geometry and downloads — steady-state
throughput approaches max(transfer, compute) instead of their sum.

Failure masking (SURVEY §5): pairs whose pose is degenerate fall back to
matching the raw pair inside the SAME batched program — their
homographies are replaced by identity, so the warp is a zero-padded copy
(MiddEval3 pairs are row-aligned already). This mirrors run_pair's
fallback up to the static canvas padding (documented deviation: near the
right edge the canvas's black padding stands in for out-of-image
candidates, exactly as it does on the rectified path).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.config import PipelineConfig
from stereo_reconstruction.data.records import StereoPair, pad_to
from stereo_reconstruction.ops import metrics as metrics_mod
from stereo_reconstruction.ops.block_search import block_search_right
from stereo_reconstruction.ops.warp import (
    band_budget,
    warp_band,
    warp_perspective,
)
from stereo_reconstruction.pipeline import _pose_device
from stereo_reconstruction.recon.disparity import (
    disparity_to_depth,
    remove_disparity_outliers,
)
from stereo_reconstruction.rectify.loop_zhang import loop_zhang_homographies
from stereo_reconstruction.rectify.rectifier import static_canvas


@dataclasses.dataclass
class BatchResult:
    disparity: np.ndarray          # (B, H, W) original-frame right disparity
    depth: Optional[np.ndarray]    # (B, H, W); None when fetch_depth=False
    pose: object                   # vmapped PoseEstimate (leaves have B dim)
    pose_ok: np.ndarray            # (B,) bool — valid pose used for rectify
    metrics: List[Dict[str, float]]
    timings: Dict[str, float]


def _compact_images(arr: np.ndarray) -> np.ndarray:
    """Smallest dtype that represents the pixel values EXACTLY, for the
    host->device transfer (a quarter of the f32 bytes for uint8). uint8
    covers raw images; f16 covers area-downsampled means (quarter-integers are
    exact in f16 up to 2048); otherwise f32 unchanged. The device
    programs cast back to f32, so results are bit-identical."""
    if arr.dtype == np.uint8:
        return arr
    if arr.dtype == np.float32:
        as16 = arr.astype(np.float16)
        if np.array_equal(arr, as16.astype(np.float32)):
            return as16
    return arr


@functools.partial(jax.jit, static_argnames=("config",))
def _pose_batch(keys, left, right, K_left, K_right, config: PipelineConfig):
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    return jax.vmap(
        lambda k, l, r, kl, kr: _pose_device(k, l, r, kl, kr, config)
    )(keys, left, right, K_left, K_right)


@functools.partial(jax.jit, static_argnames=("config", "canvas", "out_shape",
                                             "band"))
def _dense_batch(left, right, H_left, H_right, K_right, pose_ok,
                 config: PipelineConfig, canvas, out_shape, band=None):
    eye = jnp.eye(3, dtype=jnp.float32)

    def warp(img, h, shape, method):
        # band = (dy, dx) static budget covering every pair in the batch:
        # the gather-free shift-and-accumulate warp (ops/warp.py
        # warp_band); None -> general gather warp
        if band is None:
            return warp_perspective(img, h, shape, method=method)
        return warp_band(img, h, shape, band[0], band[1], method=method)

    def one(l, r, hl, hr, k, ok):
        hl = jnp.where(ok, hl, eye)
        hr = jnp.where(ok, hr, eye)
        rect_l = warp(l.astype(jnp.float32), hl, canvas, "bilinear")
        rect_r = warp(r.astype(jnp.float32), hr, canvas, "bilinear")
        disp_rect = block_search_right(rect_l, rect_r, config.matcher)
        # NN back-warp of disparity VALUES (the reference's approximation,
        # rectification.cpp:70-88, corrected to the right-image H)
        disp = warp(disp_rect, jnp.linalg.inv(hr), out_shape, "nearest")
        disp_clean = remove_disparity_outliers(
            disp, config.recon.outlier_kernel,
            config.recon.outlier_front, config.recon.outlier_back)
        depth = disparity_to_depth(disp_clean, k[0, 0], config.recon.baseline)
        # disparities are integer-valued (argmin indices through an exact
        # NN back-warp) well inside int16 range: download 2 bytes/px
        # instead of 4, exactly. rint (not truncation) so a future
        # subpixel matcher rounds instead of silently diverging from the
        # f32 disparity the on-device metrics score.
        return disp, jnp.rint(disp).astype(jnp.int16), depth

    return jax.vmap(one)(left, right, H_left, H_right, K_right, pose_ok)


@jax.jit
def _evaldisp_batch(disp, gt, mask, max_disp):
    return jax.vmap(
        lambda d, g, m, x: metrics_mod.evaldisp(d, g, m, 2.0, x)
    )(disp, gt, mask, max_disp)


_BAND_CACHE: Dict = {}
_BAND_CLASSES = (2, 4, 8, 16, 32, 64)


def _sticky_band(key, band):
    """Monotone per-process band-class cache (see _stage_host_geometry).
    The FIRST band for a key is bumped one class up, so the per-batch
    pose jitter that flips adjacent classes stays inside the
    already-compiled program (a flip costs a fresh compile of the dense
    program; an over-wide band costs a few extra zero-weight taps).
    None (gather fallback) neither grows nor consults the cache — its
    program is band-independent."""
    if band is None:
        return None
    prev = _BAND_CACHE.get(key)
    if prev is None:
        def bump(c):
            i = _BAND_CLASSES.index(c)
            return _BAND_CLASSES[min(i + 1, len(_BAND_CLASSES) - 1)]
        band = (bump(band[0]), bump(band[1]))
    else:
        band = (max(band[0], prev[0]), max(band[1], prev[1]))
    _BAND_CACHE[key] = band
    return band


@dataclasses.dataclass
class _Staged:
    """Per-batch pipeline state across the dispatch/sync phases."""
    pairs: Sequence[StereoPair]
    padded: list
    hmax: int
    wmax: int
    L: jnp.ndarray
    R: jnp.ndarray
    KL: jnp.ndarray
    KR: jnp.ndarray
    keys: jnp.ndarray
    timings: Dict[str, float]
    pose: object = None
    pose_ok: Optional[np.ndarray] = None
    err_ba: Optional[np.ndarray] = None
    disp_dev: Optional[jnp.ndarray] = None
    disp_i16: Optional[jnp.ndarray] = None
    depth: Optional[jnp.ndarray] = None
    ev: Optional[dict] = None
    gt_idx: Optional[list] = None


def _stage_upload(pairs, config, key, mesh) -> _Staged:
    """Pad/stack on host and start the (async) device uploads."""
    B = len(pairs)
    hmax = max(p.height for p in pairs)
    wmax = max(p.width for p in pairs)
    hmax += (-hmax) % 8
    wmax += (-wmax) % 128
    padded = [pad_to(p, hmax, wmax) for p in pairs]

    L = jnp.asarray(_compact_images(
        np.stack([np.asarray(p.image_left) for p in padded])))
    R = jnp.asarray(_compact_images(
        np.stack([np.asarray(p.image_right) for p in padded])))
    KL = jnp.stack([jnp.asarray(p.intrinsics_left) for p in padded])
    KR = jnp.stack([jnp.asarray(p.intrinsics_right) for p in padded])
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(B))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def shard(x, rank):
            spec = P(*(("data",) + (None,) * (rank - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))

        L, R = shard(L, 4), shard(R, 4)
        KL, KR = shard(KL, 3), shard(KR, 3)
        keys = shard(keys, 1)

    return _Staged(pairs=pairs, padded=padded, hmax=hmax, wmax=wmax,
                   L=L, R=R, KL=KL, KR=KR, keys=keys, timings={})


def _stage_pose_dispatch(st: _Staged, config) -> None:
    t0 = time.perf_counter()
    st.pose = _pose_batch(st.keys, st.L, st.R, st.KL, st.KR, config)
    st.timings["pose_dispatch"] = time.perf_counter() - t0


def _stage_host_geometry(st: _Staged, config) -> None:
    """Sync the pose outputs, run host Loop-Zhang, dispatch the dense
    program and the batched metric (both async)."""
    B = len(st.pairs)
    t0 = time.perf_counter()
    F_all = np.asarray(st.pose.fundamental, np.float64)     # sync point
    valid = np.asarray(st.pose.valid)
    st.err_ba = np.asarray(st.pose.reproj_error_ba)
    st.timings["pose"] = time.perf_counter() - t0

    # host: Loop-Zhang per pair — 3x3 f64 math (microseconds per pair)
    t0 = time.perf_counter()
    pose_ok = valid & (st.err_ba < 50.0)
    Hl = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    Hr = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    for i in range(B):
        if pose_ok[i]:
            try:
                # the pair's TRUE shape, not the batch padding: the
                # shearing stage normalizes by the image corners, and the
                # back-warp resamples disparity VALUES — a wrong canvas
                # scale would rescale every disparity
                homs = loop_zhang_homographies(
                    F_all[i],
                    (st.pairs[i].height, st.pairs[i].width),
                    (st.pairs[i].height, st.pairs[i].width))
                Hl[i] = homs.H_left.astype(np.float32)
                Hr[i] = homs.H_right.astype(np.float32)
            except Exception:
                pose_ok[i] = False                          # degenerate F
    st.pose_ok = pose_ok
    st.timings["loop_zhang_host"] = time.perf_counter() - t0

    canvas = static_canvas((st.hmax, st.wmax), (st.hmax, st.wmax),
                           config.rectify)

    # static warp-band budget covering all three warps of every pair
    # (see _dense_batch.warp); any pair exceeding the largest class
    # drops the whole batch to the gather warp
    budgets = []
    for i in range(B):
        if not pose_ok[i]:
            continue
        budgets.append(band_budget(Hl[i], canvas, (st.hmax, st.wmax)))
        budgets.append(band_budget(Hr[i], canvas, (st.hmax, st.wmax)))
        budgets.append(band_budget(
            np.linalg.inv(np.asarray(Hr[i], np.float64)),
            (st.hmax, st.wmax), canvas))
    if budgets and all(b is not None for b in budgets):
        band = (max(b[0] for b in budgets), max(b[1] for b in budgets))
    elif budgets:
        band = None
    else:
        band = (2, 2)                                   # all-identity batch
    # STICKY-MAX: ``band`` is a static arg of _dense_batch, so every new
    # class is a fresh device compile, and per-batch pose jitter flips
    # adjacent classes. Growing the class monotonically per (shapes,
    # config) reuses the
    # biggest-seen program — at most log2(max_class) compiles ever, and a
    # slightly-too-wide band is still EXACT (the extra taps carry zero
    # hat weight).
    band = _sticky_band((st.hmax, st.wmax, canvas, config), band)

    t0 = time.perf_counter()
    st.disp_dev, st.disp_i16, st.depth = _dense_batch(
        st.L, st.R, jnp.asarray(Hl), jnp.asarray(Hr), st.KR,
        jnp.asarray(pose_ok), config, canvas, (st.hmax, st.wmax), band)

    # score every pair with GT in ONE vmapped device call (not one
    # dispatch and one host round trip per pair)
    st.gt_idx = [i for i, p in enumerate(st.padded)
                 if p.disp_right_gt is not None
                 and p.mask_right_nocc is not None]
    if st.gt_idx:
        st.ev = _evaldisp_batch(
            st.disp_dev[jnp.asarray(st.gt_idx)],        # stays on device
            jnp.stack([jnp.asarray(st.padded[i].disp_right_gt)
                       for i in st.gt_idx]),
            jnp.stack([jnp.asarray(st.padded[i].mask_right_nocc)
                       for i in st.gt_idx]),
            jnp.asarray([float(st.pairs[i].ndisp or 1e9)
                         for i in st.gt_idx], jnp.float32),
        )
    st.timings["dense_dispatch"] = time.perf_counter() - t0


def _stage_collect(st: _Staged, fetch_depth: bool) -> BatchResult:
    """Sync the downloads and assemble the result."""
    B = len(st.pairs)
    t0 = time.perf_counter()
    # download the exact int16 disparities (half the bytes); depth
    # only when the caller wants maps for reconstruction
    disp_np = jax.device_get(st.disp_i16).astype(np.float32)
    depth_np = jax.device_get(st.depth) if fetch_depth else None
    st.timings["dense"] = (time.perf_counter() - t0
                           + st.timings.pop("dense_dispatch", 0.0))

    metrics: List[Dict[str, float]] = [
        {"pose_ok": float(st.pose_ok[i]),
         "reproj_error_ba": float(st.err_ba[i])}
        for i in range(B)
    ]
    if st.gt_idx:
        ev = {k: np.asarray(v) for k, v in st.ev.items()}
        for j, i in enumerate(st.gt_idx):
            metrics[i].update({k: float(v[j]) for k, v in ev.items()})

    return BatchResult(
        disparity=disp_np,
        depth=depth_np,
        pose=st.pose,
        pose_ok=st.pose_ok,
        metrics=metrics,
        timings=st.timings,
    )


def run_batch(
    pairs: Sequence[StereoPair],
    config: PipelineConfig = PipelineConfig(),
    key: Optional[jax.Array] = None,
    mesh=None,
    fetch_depth: bool = True,
) -> BatchResult:
    """Full reconstruction of a batch of stereo pairs (reference main.cpp
    flow, batched; see module docstring).

    ``mesh``: a ``jax.sharding.Mesh`` with a ``"data"`` axis shards the
    batch across devices — both device programs are vmapped over B, so
    XLA SPMD-partitions them along the batch dimension with no
    cross-pair collectives (the pairs are independent until the metric
    reduce). B must be a multiple of the axis size.

    ``fetch_depth=False`` skips the depth-map download (metrics and
    disparities are unaffected; ``BatchResult.depth`` is None) — the
    right mode when only scores/disparities are consumed.
    """
    key = jax.random.key(config.seed) if key is None else key
    st = _stage_upload(pairs, config, key, mesh)
    _stage_pose_dispatch(st, config)
    _stage_host_geometry(st, config)
    res = _stage_collect(st, fetch_depth)
    # fold dispatch time into the pose stage for the sequential API
    res.timings["pose"] += res.timings.pop("pose_dispatch", 0.0)
    return res


def run_batches(
    batches: Sequence[Sequence[StereoPair]],
    config: PipelineConfig = PipelineConfig(),
    key: Optional[jax.Array] = None,
    mesh=None,
    fetch_depth: bool = True,
) -> List[BatchResult]:
    """Software-pipelined multi-batch runner.

    Batch i+1's image upload and pose program are dispatched BEFORE batch
    i's host geometry blocks on its pose outputs, and batch i's downloads
    drain while i+1 computes — this overlaps transfer and host work with
    compute, so steady-state throughput approaches max(transfer, compute)
    instead of their sum. Results
    are identical to calling ``run_batch`` per batch with keys
    ``fold_in(key, batch_index)``.
    """
    if not batches:
        return []
    key = jax.random.key(config.seed) if key is None else key
    n = len(batches)
    sts: List[Optional[_Staged]] = [None] * n
    results: List[Optional[BatchResult]] = [None] * n
    for i in range(n):
        sts[i] = _stage_upload(batches[i], config,
                               jax.random.fold_in(key, i), mesh)
        _stage_pose_dispatch(sts[i], config)
        if i >= 1:
            _stage_host_geometry(sts[i - 1], config)
        if i >= 2:
            results[i - 2] = _stage_collect(sts[i - 2], fetch_depth)
            sts[i - 2] = None
    _stage_host_geometry(sts[n - 1], config)
    if n >= 2:
        results[n - 2] = _stage_collect(sts[n - 2], fetch_depth)
    results[n - 1] = _stage_collect(sts[n - 1], fetch_depth)
    return results
