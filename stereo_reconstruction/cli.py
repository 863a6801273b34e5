"""Command-line interface: ``python -m stereo_reconstruction <cmd>``.

The reference has no CLI (scenario index hard-coded at main.cpp:20). Here:

  run    — full reconstruction of one or more scenarios
  eval   — disparity metrics against GT (when the GT PFMs are present) or
           against the NumPy reference oracle
  bench  — thin wrapper over bench.py semantics

Example:
  python -m stereo_reconstruction run --data /root/reference/data/MiddEval3 \
      --scenario 13 --out results/ --mesh
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereo_reconstruction")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="full pipeline on scenarios")
    run_p.add_argument("--data", required=True, help="MiddEval3 root")
    run_p.add_argument("--scenario", type=int, nargs="+", default=[13])
    run_p.add_argument("--split", default="training", choices=["training", "test"])
    run_p.add_argument("--out", default="results")
    run_p.add_argument("--mesh", action="store_true")
    run_p.add_argument("--downsample", type=int, default=1)
    run_p.add_argument("--max-disparity", type=int, default=200)
    run_p.add_argument("--matcher", default="ssd",
                       choices=["ssd", "sad", "ncc", "perceptual"],
                       help="dense matching cost (perceptual = LPIPS search)")
    run_p.add_argument("--weights", default="",
                       help="converted VGG/LPIPS weights .npz for --matcher "
                            "perceptual (default: deterministic He-init)")
    run_p.add_argument("--png-compat", action="store_true",
                       help="quantize disparity through uint8 PNG like the reference")
    run_p.add_argument("--batch", action="store_true",
                       help="run all scenarios as ONE batched device "
                            "program pair (pipeline_batch.run_batch)")

    eval_p = sub.add_parser("eval", help="score a disparity PFM against GT")
    eval_p.add_argument("--disp", required=True)
    eval_p.add_argument("--gt", required=True)
    eval_p.add_argument("--mask", required=True)
    eval_p.add_argument("--bad-thresh", type=float, default=2.0)
    eval_p.add_argument("--max-disp", type=float, default=1e9)

    rect_p = sub.add_parser(
        "rectify", help="uncalibrated ORB+F pipeline (reference rectification_main)"
    )
    rect_p.add_argument("--data", required=True, help="MiddEval3 root")
    rect_p.add_argument("--scenario", type=int, default=13)
    rect_p.add_argument("--split", default="training", choices=["training", "test"])
    rect_p.add_argument("--out", default="results/rectified")
    rect_p.add_argument("--detector", default="orb", choices=["orb", "brisk", "dog"])
    rect_p.add_argument("--downsample", type=int, default=1)
    rect_p.add_argument("--max-disparity", type=int, default=200)

    hit_p = sub.add_parser(
        "reconstruct", help="RUN_ALL=0 path: mesh a precomputed disparity map"
    )
    hit_p.add_argument("--data", required=True, help="MiddEval3 root")
    hit_p.add_argument("--results", required=True,
                       help="precomputed results root (e.g. results/HitNet)")
    hit_p.add_argument("--scenario", type=int, default=13)
    hit_p.add_argument("--out", default="results/reconstruction_mesh.off")
    hit_p.add_argument("--no-gt-rescale", action="store_true")

    bench_p = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    bench_p.add_argument("--quick", action="store_true")

    args = ap.parse_args(argv)

    from stereo_reconstruction.utils import compile_cache

    compile_cache.enable()
    if args.cmd == "run":
        _cmd_run(args)
    elif args.cmd == "eval":
        _cmd_eval(args)
    elif args.cmd == "rectify":
        _cmd_rectify(args)
    elif args.cmd == "reconstruct":
        _cmd_reconstruct(args)
    elif args.cmd == "bench":
        _cmd_bench(args)


def _cmd_run(args):
    import dataclasses

    from stereo_reconstruction.config import PipelineConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair
    from stereo_reconstruction.pipeline import run_pair

    config = PipelineConfig()
    config = config.replace(
        matcher=dataclasses.replace(
            config.matcher, max_disparity=args.max_disparity, cost=args.matcher
        ),
        perceptual=dataclasses.replace(config.perceptual, weights_path=args.weights),
    )
    ds = MiddEval3(args.data)

    if args.batch:
        from stereo_reconstruction.pipeline_batch import run_batch

        pairs = []
        for idx in args.scenario:
            pair = (ds.load_training(idx) if args.split == "training"
                    else ds.load_test(idx))
            for _ in range(max(0, args.downsample - 1)):
                pair = downsample_pair(pair)
            pairs.append(pair)
        res = run_batch(pairs, config)
        for pair, m in zip(pairs, res.metrics):
            print(json.dumps({"scenario": pair.name, **m,
                              "timings": res.timings}))
        return

    for idx in args.scenario:
        pair = (
            ds.load_training(idx) if args.split == "training" else ds.load_test(idx)
        )
        for _ in range(max(0, args.downsample - 1)):
            pair = downsample_pair(pair)
        result = run_pair(
            pair,
            config,
            output_dir=args.out,
            write_mesh=args.mesh,
            png_compat=args.png_compat,
        )
        print(
            json.dumps(
                {
                    "scenario": pair.name,
                    "metrics": result.metrics,
                    "timings": {k: round(v, 3) for k, v in result.timings.items()},
                }
            )
        )


def _cmd_eval(args):
    import jax.numpy as jnp

    from stereo_reconstruction.io import read_image, read_pfm
    from stereo_reconstruction.ops.metrics import evaldisp

    disp = read_pfm(args.disp)
    gt = read_pfm(args.gt)
    mask = read_image(args.mask, grayscale=True)
    m = evaldisp(
        jnp.asarray(disp), jnp.asarray(gt), jnp.asarray(mask),
        bad_thresh=args.bad_thresh, max_disp=args.max_disp,
    )
    print(json.dumps({k: float(v) for k, v in m.items()}))


def _cmd_rectify(args):
    import dataclasses

    from stereo_reconstruction.config import PipelineConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair
    from stereo_reconstruction.pipeline_uncalibrated import run_uncalibrated

    config = PipelineConfig()
    config = config.replace(
        matcher=dataclasses.replace(config.matcher, max_disparity=args.max_disparity)
    )
    ds = MiddEval3(args.data)
    pair = (
        ds.load_training(args.scenario)
        if args.split == "training"
        else ds.load_test(args.scenario)
    )
    for _ in range(max(0, args.downsample - 1)):
        pair = downsample_pair(pair)
    res = run_uncalibrated(
        np.asarray(pair.image_left),
        np.asarray(pair.image_right),
        config,
        detector=args.detector,
        output_dir=args.out,
    )
    print(
        json.dumps(
            {
                "scenario": pair.name,
                "num_inliers": res.num_inliers,
                "F": np.asarray(res.F).tolist(),
                "F_rectified": None
                if res.F_rectified is None
                else np.asarray(res.F_rectified).tolist(),
            }
        )
    )


def _cmd_reconstruct(args):
    from stereo_reconstruction.config import PipelineConfig
    from stereo_reconstruction.data import (
        MiddEval3,
        PrecomputedDisparities,
        rescale_to_gt_mean,
    )
    from stereo_reconstruction.pipeline import reconstruct_from_disparity

    ds = MiddEval3(args.data)
    pd = PrecomputedDisparities(args.results)
    pair = ds.load_training(args.scenario)
    disp = pd.load_training(args.scenario)
    if not args.no_gt_rescale and pair.disp_left_gt is not None:
        disp = rescale_to_gt_mean(disp, pair.disp_left_gt)
    _, depth = reconstruct_from_disparity(
        pair, disp, PipelineConfig(), output_path=args.out
    )
    print(
        json.dumps(
            {
                "scenario": pair.name,
                "mesh": args.out,
                "depth_valid_frac": float((depth > 0).mean()),
            }
        )
    )


def _cmd_bench(args):
    import runpy
    import os

    sys.argv = ["bench.py"] + (["--quick"] if args.quick else [])
    bench = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py")
    runpy.run_path(bench, run_name="__main__")


if __name__ == "__main__":
    main()
