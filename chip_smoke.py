#!/usr/bin/env python3
"""Smoke run of the stereo pipeline on NVIDIA GPUs, through its entry points.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the sharded paths only

One card, at the reference's operating point (MiddEval3 half resolution,
750x900, D=200, block 17, smoothing 0.9; src/main.cpp:40), on seeded
synthetic scenes (stereo_reconstruction/data/synthetic.py):

  device    the visible devices must all be GPUs; names the card
  kernel    the fused matcher kernel against the plain XLA path on
            integer-valued images: all five planes bit-equal; both times
  matcher   block_search_right against the NumPy reference oracle on a
            band of full-width rows (exact-agreement share), and bad-2.0
            against ground truth on the full frame
  run_pair  pose -> rectification -> matching -> reconstruction; pose and
            disparity against the scene's truth; PFM/JSON/OFF artifacts
            written and read back
  run_batch B=8 distinct pairs through pipeline_batch.run_batch

``--multi`` (four cards) runs run_batch over a ``data=4`` mesh and the
same batch on one card (both held to the truth bounds), and the
tile-sharded exact matcher over a ``tile=4`` mesh against
block_search_right on one card (bit for bit).

Each phase prints one JSON line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failure raises before it and the exit code is non-zero. There is no
CPU fallback: a host without a GPU fails in the device phase.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from stereo_reconstruction.utils import compile_cache

compile_cache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stereo_reconstruction import oracle  # noqa: E402
from stereo_reconstruction.config import MatcherConfig, PipelineConfig  # noqa: E402
from stereo_reconstruction.data.records import pad_to  # noqa: E402
from stereo_reconstruction.data.synthetic import make_scene, pose_errors_deg  # noqa: E402
from stereo_reconstruction.io.mesh_io import read_off  # noqa: E402
from stereo_reconstruction.io.pfm import read_pfm  # noqa: E402
from stereo_reconstruction.ops import cost_volume as cv  # noqa: E402
from stereo_reconstruction.ops import pallas_cost_volume as pcv  # noqa: E402
from stereo_reconstruction.ops import smoothing  # noqa: E402
from stereo_reconstruction.ops.block_search import block_search_right  # noqa: E402
from stereo_reconstruction.ops.metrics import evaldisp  # noqa: E402
from stereo_reconstruction.parallel import make_mesh, sharded_block_search_right  # noqa: E402
from stereo_reconstruction.pipeline import run_pair  # noqa: E402
from stereo_reconstruction.pipeline_batch import run_batch  # noqa: E402

HEIGHT, WIDTH, MAX_DISPARITY, BLOCK, SMOOTH = 750, 900, 200, 17, 0.9
BATCH = 8
ORACLE_ROWS = 64
# bounds set on the CPU at 188x225, D=50 (tests/test_chip_smoke.py): the
# worst of seeds 1-8 there was 0.86 deg, 3.85 deg and 10.3 % bad-2.0
MIN_ORACLE_AGREEMENT = 0.99
MAX_BAD2_PERCENT = 15.0
MAX_ROTATION_ERROR_DEG = 1.5
MAX_TRANSLATION_ERROR_DEG = 6.0


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def median_ms(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``reps`` warm calls, each to block_until_ready."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def card_name() -> str:
    """``name, power.limit`` of the cards, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def pipeline_config(max_disparity: int) -> PipelineConfig:
    cfg = PipelineConfig()
    return cfg.replace(matcher=dataclasses.replace(
        cfg.matcher, block_size=BLOCK, max_disparity=max_disparity,
        smooth_factor=SMOOTH))


def render(seeds, height, width, max_disparity, rectified=False):
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(
            lambda s: make_scene(s, height, width, max_disparity, rectified),
            seeds))


def phase_device(count: int) -> dict:
    devs = jax.devices()
    check(all(d.platform == "gpu" for d in devs),
          f"chip_smoke needs GPUs; JAX sees {[d.platform for d in devs]}")
    check(len(devs) == count, f"expected {count} GPU(s), JAX sees {len(devs)}")
    name = card_name()
    print(name, flush=True)
    return {"phase": "device", "platform": devs[0].platform,
            "kind": devs[0].device_kind, "count": len(devs),
            "jax": jax.__version__, "nvidia_smi": name}


def phase_kernel(left, right, max_disparity: int, interpret=False) -> dict:
    """Fused kernel vs the plain path on integer-valued images: bit-equal."""
    kern = jax.jit(lambda l, r: pcv.pallas_matcher_inputs(
        l, r, BLOCK, 0, max_disparity, interpret=interpret))
    plain = jax.jit(lambda l, r: smoothing.volume_reductions(
        cv.cost_volume_right_ssd(l, r, BLOCK, 0, max_disparity), 0))
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    got = [np.asarray(x) for x in kern(left, right)]
    want = [np.asarray(x) for x in plain(left, right)]
    names = ("m0", "a0", "c_zero", "diag_up", "diag_lf")
    differ = [n for n, g, w in zip(names, got, want) if not np.array_equal(g, w)]
    check(not differ, f"fused kernel differs from the plain path in {differ}")
    return {"phase": "kernel", "shape": list(right.shape[:2]),
            "max_disparity": max_disparity, "bit_equal": True,
            "kernel_ms": median_ms(kern, left, right),
            "plain_ms": median_ms(plain, left, right)}


def phase_matcher(scene, max_disparity: int, band_rows: int = ORACLE_ROWS,
                  interpret=False) -> dict:
    """block_search_right vs the NumPy oracle on a full-width band, and
    bad-2.0 against ground truth on the whole frame."""
    pair = scene.pair
    cfg = MatcherConfig(block_size=BLOCK, max_disparity=max_disparity,
                        smooth_factor=SMOOTH)
    L = np.asarray(pair.image_left)
    R = np.asarray(pair.image_right)
    fn = jax.jit(lambda l, r: block_search_right(l, r, cfg, interpret))
    disp = np.asarray(fn(jnp.asarray(L), jnp.asarray(R)))
    y0 = (L.shape[0] - band_rows) // 2
    band = slice(y0, y0 + band_rows)
    got = np.asarray(block_search_right(jnp.asarray(L[band]),
                                        jnp.asarray(R[band]), cfg, interpret))
    want = oracle.block_search_right_fast(L[band], R[band], BLOCK, 0,
                                          max_disparity, SMOOTH)
    agreement = float(np.mean(got == want))
    check(agreement >= MIN_ORACLE_AGREEMENT,
          f"matcher agrees with the oracle on {agreement:.4f} of the band")
    m = evaldisp(jnp.asarray(disp), jnp.asarray(pair.disp_right_gt),
                 jnp.asarray(pair.mask_right_nocc), 2.0, float(max_disparity))
    return {"phase": "matcher", "kernel": pcv.use_kernel(cfg, interpret),
            "oracle_rows": band_rows, "oracle_agreement": agreement,
            "bad2_percent_vs_truth": float(m["bad_percent"]),
            "matcher_ms": median_ms(fn, jnp.asarray(L), jnp.asarray(R))}


def _pose_and_quality(metrics: dict, pose, scene) -> dict:
    check(metrics["pose_ok"] == 1.0, f"pose rejected: {metrics}")
    rot, trans = pose_errors_deg(np.asarray(pose), scene.rotation,
                                 scene.translation)
    check(rot <= MAX_ROTATION_ERROR_DEG, f"rotation error {rot:.3f} deg")
    check(trans <= MAX_TRANSLATION_ERROR_DEG,
          f"translation direction error {trans:.3f} deg")
    bad2 = metrics["bad_percent"]
    check(bad2 <= MAX_BAD2_PERCENT, f"bad-2.0 {bad2:.2f} % vs truth")
    return {"rotation_error_deg": rot, "translation_error_deg": trans,
            "bad2_percent_vs_truth": bad2}


def phase_run_pair(scene, config: PipelineConfig) -> dict:
    """One pair through run_pair; the staged artifacts are read back."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run_pair(scene.pair, config)
        first_s = time.perf_counter() - t0
        res = run_pair(scene.pair, config, output_dir=out, write_mesh=True)
        record = {"phase": "run_pair", "first_call_s": first_s,
                  "warm_stage_s": res.timings,
                  **_pose_and_quality(res.metrics, res.pose.pose, scene)}
        valid = res.disparity != 0
        check(np.isfinite(res.depth[valid]).all() and valid.mean() > 0.5,
              "depth is not finite over the matched pixels")
        stem = os.path.join(out, scene.pair.name)
        check(np.array_equal(read_pfm(stem + "_disp.pfm"), res.disparity),
              "disparity PFM does not read back")
        with open(stem + "_pose.json") as f:
            saved = json.load(f)
        check(np.allclose(saved["pose"], np.asarray(res.pose.pose)),
              "pose JSON does not read back")
        verts, _, faces = read_off(stem + "_mesh.off")
        check(len(verts) > 0 and len(faces) > 0, "empty mesh")
        record["mesh_vertices"] = int(len(verts))
    return record


def phase_run_batch(scenes, config: PipelineConfig, mesh=None) -> tuple:
    """B pairs through run_batch; returns (record, disparities)."""
    pairs = [s.pair for s in scenes]
    t0 = time.perf_counter()
    run_batch(pairs, config, mesh=mesh)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run_batch(pairs, config, mesh=mesh)
    warm_s = time.perf_counter() - t0
    check(np.isfinite(res.disparity).all(), "non-finite disparity")
    quality = [_pose_and_quality(m, res.pose.pose[i], s)
               for i, (m, s) in enumerate(zip(res.metrics, scenes))]
    return ({"phase": "run_batch", "batch": len(pairs),
             "mesh": None if mesh is None else dict(mesh.shape),
             "first_call_s": first_s, "warm_wall_s": warm_s,
             "pairs_per_s": len(pairs) / warm_s, "warm_stage_s": res.timings,
             "bad2_percent_vs_truth": [q["bad2_percent_vs_truth"]
                                       for q in quality]},
            res.disparity)


def phase_multi_batch(scenes, config: PipelineConfig, data: int) -> dict:
    """run_batch over a data-parallel mesh vs the same batch on one card.

    Both runs must meet the truth bounds for every pair. Their disparities
    are compared but not required to be equal: each device compiles the
    partitioned program for its own share of the batch, so the pose stage
    sums in another order, and RANSAC's inlier vote can then pick another
    hypothesis (on four virtual CPU devices it did for 4 of 4 pairs)."""
    single, d1 = phase_run_batch(scenes, config)
    mesh = make_mesh(data=data, tile=1, devices=jax.devices()[:data])
    sharded, dn = phase_run_batch(scenes, config, mesh=mesh)
    return {"phase": "multi_run_batch",
            "disparity_equal_share": float(np.mean(d1 == dn)),
            "single": single, "sharded": sharded}


def phase_multi_tile(scene, max_disparity: int, tiles: int,
                     interpret=False) -> dict:
    """Exact tile-sharded matcher vs block_search_right on one card."""
    cfg = MatcherConfig(block_size=BLOCK, max_disparity=max_disparity,
                        smooth_factor=SMOOTH)
    h = scene.pair.height
    pair = pad_to(scene.pair, h + (-h) % (8 * tiles), scene.pair.width)
    L = jnp.asarray(np.asarray(pair.image_left)[None])
    R = jnp.asarray(np.asarray(pair.image_right)[None])
    mesh = make_mesh(data=1, tile=tiles, devices=jax.devices()[:tiles])
    t0 = time.perf_counter()
    got = np.asarray(sharded_block_search_right(
        L, R, mesh, cfg, exact=True, interpret=interpret))[0]
    sharded_s = time.perf_counter() - t0
    one = jax.device_put((L[0], R[0]), jax.devices()[0])
    want = np.asarray(block_search_right(*one, cfg, interpret))
    check(np.array_equal(got, want), "tile-sharded matcher differs from one card")
    return {"phase": "multi_tile_matcher", "tiles": tiles,
            "shape": list(L.shape[1:3]), "bit_equal": True,
            "first_call_s": sharded_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded paths against one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1

    t_start = time.perf_counter()
    dev = phase_device(count)
    emit(dev)
    config = pipeline_config(MAX_DISPARITY)
    seeds = [args.seed + 1 + i for i in range(BATCH)]
    scenes = render(seeds, HEIGHT, WIDTH, MAX_DISPARITY)
    if args.multi:
        emit(phase_multi_batch(scenes, config, data=count))
        (flat,) = render([args.seed], HEIGHT, WIDTH, MAX_DISPARITY, True)
        emit(phase_multi_tile(flat, MAX_DISPARITY, tiles=count))
    else:
        (flat,) = render([args.seed], HEIGHT, WIDTH, MAX_DISPARITY, True)
        if pcv.use_kernel(config.matcher):
            emit({**phase_kernel(flat.pair.image_left, flat.pair.image_right,
                                 MAX_DISPARITY), "card": dev["nvidia_smi"]})
        emit(phase_matcher(flat, MAX_DISPARITY))
        emit(phase_run_pair(scenes[0], config))
        emit(phase_run_batch(scenes, config)[0])
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": dev["platform"],
                                 "kind": dev["kind"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
