#!/usr/bin/env python3
"""Benchmark: rectified pairs/s per card on the dense matcher, plus the
single-pair and batched pipelines, on one NVIDIA GPU.

Inputs are seeded synthetic scenes (stereo_reconstruction/data/synthetic.py)
with the reference's matcher settings (block 17, smoothing 0.9;
src/main.cpp:40) at one of two operating points:

  default   375x450, D=100   (MiddEval3 trainingQ size)
  --full    750x900, D=200   (half resolution, the reference's own)

Sections, each followed by the full cumulative JSON line
  {"metric": "rectified_pairs_per_s_per_chip", "value": N, "unit": "pairs/s",
   "vs_baseline": N / 50, "extra": {...}}
(the last line is the most complete):

  matcher        B pairs through vmapped block_search_right; ms/pair is the
                 median of ``--reps`` warm calls, each to block_until_ready
  quality_guard  block_search_right against the NumPy oracle on a crop
  run_pair       one pair end to end: first-call and warm stage times
  run_batch      B distinct pairs through pipeline_batch.run_batch

Every record names the device (platform, device_kind, count). A host
without a GPU is refused: a CPU time is not a device number.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from stereo_reconstruction.utils import compile_cache  # noqa: E402

compile_cache.enable()

TARGET_PAIRS_PER_S = 50.0  # BASELINE.json north_star


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="trainingQ size (the default)")
    ap.add_argument("--full", action="store_true",
                    help="half resolution, D=200, instead of trainingQ")
    ap.add_argument("--backend", default="auto",
                    help="matcher backend: auto | pallas | xla")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--skip-pipeline", action="store_true",
                    help="matcher and quality guard only")
    args = ap.parse_args()
    if args.quick and args.full:
        ap.error("--quick and --full are mutually exclusive")

    import dataclasses

    import jax
    import jax.numpy as jnp

    from stereo_reconstruction import oracle
    from stereo_reconstruction.config import MatcherConfig, PipelineConfig
    from stereo_reconstruction.data.synthetic import make_scene
    from stereo_reconstruction.ops.block_search import block_search_right

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX sees {devs[0].platform}")
    h, w, dmax = (750, 900, 200) if args.full else (375, 450, 100)
    B = args.batch
    cfg = MatcherConfig(block_size=17, max_disparity=dmax, smooth_factor=0.9,
                        backend=args.backend)
    extra = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
             "device_count": len(devs),
             "config": "half_D200" if args.full else "trainingQ_D100",
             "backend": cfg.backend, "image": f"{h}x{w}", "batch": B,
             "max_disparity": dmax, "sections": {}}
    record = {"metric": "rectified_pairs_per_s_per_chip", "value": 0.0,
              "unit": "pairs/s", "vs_baseline": 0.0, "extra": extra}

    def flush():
        record["vs_baseline"] = record["value"] / TARGET_PAIRS_PER_S
        print(json.dumps(record), flush=True)

    def median_s(fn, *a):
        jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def section(name, fn):
        t0 = time.perf_counter()
        fn()
        extra["sections"][name] = {"seconds": time.perf_counter() - t0}
        flush()

    flat = [make_scene(i, h, w, dmax, rectified=True) for i in range(B)]
    L = jnp.stack([jnp.asarray(s.pair.image_left, jnp.float32) for s in flat])
    R = jnp.stack([jnp.asarray(s.pair.image_right, jnp.float32) for s in flat])

    def sec_matcher():
        step = jax.jit(jax.vmap(lambda l, r: block_search_right(l, r, cfg)))
        t0 = time.perf_counter()
        jax.block_until_ready(step(L, R))
        extra["matcher_first_call_s"] = time.perf_counter() - t0
        per_pair = median_s(step, L, R) / B
        extra["ms_per_pair"] = per_pair * 1e3
        record["value"] = 1.0 / per_pair

    def sec_quality():
        crop = (slice(100, 180), slice(100, 356))
        Lc = np.asarray(flat[0].pair.image_left)[crop]
        Rc = np.asarray(flat[0].pair.image_right)[crop]
        qcfg = dataclasses.replace(cfg, max_disparity=48)
        got = np.asarray(block_search_right(jnp.asarray(Lc), jnp.asarray(Rc),
                                            qcfg))
        want = oracle.block_search_right_fast(Lc, Rc, 17, 0, 48, 0.9)
        extra["oracle_exact_agreement_crop"] = float(np.mean(got == want))

    section("matcher", sec_matcher)
    section("quality_guard", sec_quality)
    if args.skip_pipeline:
        return

    pcfg = PipelineConfig()
    pcfg = pcfg.replace(matcher=dataclasses.replace(
        pcfg.matcher, max_disparity=dmax, backend=args.backend))
    scenes = [make_scene(100 + i, h, w, dmax) for i in range(B)]

    def sec_run_pair():
        from stereo_reconstruction.pipeline import run_pair

        t0 = time.perf_counter()
        run_pair(scenes[0].pair, pcfg)
        extra["run_pair_first_call_s"] = time.perf_counter() - t0
        res = run_pair(scenes[0].pair, pcfg)
        extra["run_pair_stages_ms"] = {k: v * 1e3
                                       for k, v in res.timings.items()}
        extra["run_pair_pairs_per_s"] = 1.0 / sum(res.timings.values())
        extra["run_pair_bad2_vs_truth"] = res.metrics.get("bad_percent")

    def sec_run_batch():
        from stereo_reconstruction.pipeline_batch import run_batch

        pairs = [s.pair for s in scenes]
        t0 = time.perf_counter()
        run_batch(pairs, pcfg)
        extra["run_batch_first_call_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_batch(pairs, pcfg)
        extra["run_batch_pairs_per_s"] = B / (time.perf_counter() - t0)
        extra["run_batch_stages_ms"] = {k: v * 1e3
                                        for k, v in res.timings.items()}
        extra["run_batch_bad2_vs_truth"] = [m.get("bad_percent")
                                            for m in res.metrics]

    section("run_pair", sec_run_pair)
    section("run_batch", sec_run_batch)


if __name__ == "__main__":
    main()
