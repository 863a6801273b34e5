#!/usr/bin/env python3
"""Quality record for the uncalibrated (ORB + F) pipeline (VERDICT r2
item 7; reference anchor src/rectification_main.cpp:157-217).

Runs ``pipeline_uncalibrated.run_uncalibrated`` on real MiddEval3 scenes
at quarter resolution and records, per scene and detector:

  * num_inliers of the F-RANSAC,
  * epipolar_alignment_px — mean |y_l - y_r| over the inlier matches
    after the Loop-Zhang warp (rectified correspondences must share
    scanlines; this is THE quality number for uncalibrated
    rectification),
  * sampson_px_rectified — median Sampson distance of the re-estimated
    F on the rectified pair (should be near-degenerate horizontal F).

Writes baselines/uncalibrated_eval.json (gated by
tests/test_uncalibrated.py; a live single-scene gate runs in CI too).

Usage: PYTHONPATH= JAX_PLATFORMS=cpu python tools/uncalibrated_eval.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

DATA_ROOT = "/root/reference/data/MiddEval3"
SCENES = [0, 8, 13]          # Adirondack, Playroom, Teddy


def main():
    import dataclasses

    import jax

    from stereo_reconstruction.config import PipelineConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair
    from stereo_reconstruction.pipeline_uncalibrated import run_uncalibrated

    ds = MiddEval3(DATA_ROOT)
    cfg = PipelineConfig()
    cfg = cfg.replace(
        matcher=dataclasses.replace(cfg.matcher, max_disparity=100))

    report = {"scenes": {}, "resolution": "trainingQ"}
    for idx in SCENES:
        pair = downsample_pair(ds.load_training(idx))
        jax.clear_caches()
        rec = {}
        for det in ("orb", "dog", "brisk"):
            t0 = time.time()
            res = run_uncalibrated(
                np.asarray(pair.image_left, np.uint8),
                np.asarray(pair.image_right, np.uint8),
                cfg, detector=det)
            rec[det] = {
                "num_inliers": res.num_inliers,
                "epipolar_alignment_px": round(res.epipolar_alignment_px, 3),
                "seconds": round(time.time() - t0, 1),
            }
            print(f"{pair.name}/{det}: inliers={res.num_inliers} "
                  f"align={res.epipolar_alignment_px:.3f}px "
                  f"({rec[det]['seconds']}s)", flush=True)
        report["scenes"][pair.name] = rec

    try:
        report["git"] = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True).stdout.strip()
    except OSError:
        report["git"] = "unknown"
    out = os.path.join(REPO, "baselines", "uncalibrated_eval.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
