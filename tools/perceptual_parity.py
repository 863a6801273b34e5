#!/usr/bin/env python3
"""BASELINE config 3 quality: the perceptual matcher vs the notebook oracle.

Runs the literal-semantics port of the reference notebook's windowed
LPIPS search (``perceptual/notebook_oracle.py``, cells 6-10) and BOTH
re-designs (``perceptual/cost.py``) on a real MiddEval3 crop with
IDENTICAL VGG weights:

  * ``windowed`` — per-window VGG embeddings, the notebook's exact
    semantics as one batched device program (the production config-3
    path; must track the oracle to f32-noise);
  * ``full_image`` — shared full-image feature maps + shifted diffs (the
    ~10x-cheaper structural approximation, kept as an option).

Records agreement/EPE per mode plus bad-2.0 against real GT on the crop.
Writes ``baselines/perceptual_parity.json`` (gated by
``tests/test_perceptual_parity_gate.py``; the gate warns when the
recorded git hash drifts from HEAD).

Pretrained LPIPS weights are not obtainable in this environment (zero
egress; documented in perceptual/vgg.py), so the comparison uses the
deterministic He-init tower — the *same* weights on both sides, which is
exactly what isolates the structural/semantic differences being scored.

Usage: PYTHONPATH= JAX_PLATFORMS=cpu python tools/perceptual_parity.py
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


def main():
    import jax.numpy as jnp

    from stereo_reconstruction.config import PerceptualConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair
    from stereo_reconstruction.perceptual import (
        get_params,
        perceptual_window_search,
    )
    from stereo_reconstruction.perceptual.notebook_oracle import (
        notebook_window_search,
    )

    pair = downsample_pair(MiddEval3(DATA_ROOT).load_training(13))  # Teddy Q
    # crop chosen so GT disparity fits the search range (GT in crop < 44)
    ys, xs = slice(150, 182), slice(140, 260)
    L = np.asarray(pair.image_left, np.float32)[ys, xs]
    R = np.asarray(pair.image_right, np.float32)[ys, xs]
    gt = np.asarray(pair.disp_right_gt, np.float32)[ys, xs]
    D = 48

    params = get_params()

    t0 = time.time()
    ref = notebook_window_search(params, L, R, max_disparity=D)
    t_ref = time.time() - t0

    # interior only: the crop's outer window band sees context the
    # notebook's zero-padded windows do not (crop border != image border)
    m = 8
    r, g = ref[m:-m, m:-m], gt[m:-m, m:-m]
    known = np.isfinite(g) & (g > 0) & (g < D)

    def bad2(d):
        return 100.0 * float((np.abs(d - g)[known] > 2.0).mean())

    report = {
        "scene": "Teddy trainingQ crop rows150:182 cols140:260 (interior)",
        "max_disparity": D,
        "weights": "he_init_seed0 (identical both sides)",
        "bad2_vs_gt_notebook_pct": round(bad2(r), 2),
        "gt_pixels": int(known.sum()),
        "runtime_notebook_s": round(t_ref, 2),
        "modes": {},
    }

    for mode in ("windowed", "full_image"):
        cfg = PerceptualConfig(max_disparity=D, mode=mode)
        t0 = time.time()
        ours = np.asarray(
            perceptual_window_search(params, jnp.asarray(L), jnp.asarray(R), cfg)
        )
        t_ours = time.time() - t0
        o = ours[m:-m, m:-m]
        diff = np.abs(o - r)
        report["modes"][mode] = {
            "agreement_exact_pct": round(100.0 * float((diff == 0).mean()), 2),
            "agreement_2px_pct": round(100.0 * float((diff <= 2.0).mean()), 2),
            "mean_abs_diff_px": round(float(diff.mean()), 3),
            "bad2_vs_gt_ours_pct": round(bad2(o), 2),
            "runtime_ours_s": round(t_ours, 2),
        }

    # back-compat top-level fields = the production (windowed) mode
    report.update({k: v for k, v in report["modes"]["windowed"].items()})
    try:
        report["git"] = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True).stdout.strip()
    except OSError:
        report["git"] = "unknown"

    out = os.path.join(REPO, "baselines", "perceptual_parity.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
