#!/usr/bin/env python3
"""Full MiddEval3 trainingQ evaluation: all 15 scenes, SSD + NCC configs.

For every trainingH scene (downsampled to trainingQ):
  1. reproduce the reference pipeline's own output (tools/reference_baseline)
     — cached under baselines/<Scene>_ds1_baseline_disp.pfm;
  2. run the framework pipeline (pose -> Loop-Zhang rectify -> window
     search -> back-warp -> outlier clamp), SSD config-1 semantics and the
     NCC config-2 variant (BASELINE.json configs[0:2]);
  3. score vs real GT where it ships (Teddy, ArtL — the other 13 scenes'
     GT PFMs are absent from this checkout) and vs the reference
     reproduction's disparity everywhere (parity metric);
  4. record per-scene pose (ours + baseline) for the ATE gate.

Writes baselines/full_eval.json + a markdown table to stdout.

Usage:
  PYTHONPATH= JAX_PLATFORMS=cpu python tools/full_eval.py [--scenes 0,5,8,12,13]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(REPO, "baselines")


def evaldisp_np(disp, gt, mask, badthresh=2.0, maxdisp=1e9):
    known = np.isfinite(gt)
    evaluated = known & (mask == 255)
    valid = disp != 0
    d = np.where(valid, np.clip(disp, 0, maxdisp), disp)
    err = np.abs(d - gt)
    n = int(evaluated.sum())
    n_valid = int((evaluated & valid).sum())
    bad = int((evaluated & valid & (err > badthresh)).sum())
    serr = float(err[evaluated & valid].sum())
    return {
        "bad_percent": 100.0 * bad / max(n, 1),
        "invalid_percent": 100.0 * (n - n_valid) / max(n, 1),
        "total_bad_percent": 100.0 * (bad + n - n_valid) / max(n, 1),
        "avg_err": serr / max(n_valid, 1),
    }


def git_hash():
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True).stdout.strip()
    except OSError:
        return "unknown"


def matcher_parity(rect_l, rect_r, max_disparity=100, block_size=17):
    """Dense-matcher parity on one rectified pair: the framework matcher
    vs the exact reference-semantics oracle on identical inputs.

    This is BOTH the per-scene record in full_eval.json and the LIVE CI
    gate (tests/test_full_eval_gate.py runs it on a Teddy crop in
    seconds) — a matcher regression fails CI without anyone regenerating
    the recorded artifacts (VERDICT r2 item 4).
    """
    import jax.numpy as jnp

    from stereo_reconstruction import oracle
    from stereo_reconstruction.config import MatcherConfig
    from stereo_reconstruction.ops.block_search import block_search_right

    t0 = time.time()
    od = oracle.block_search_right_fast(
        rect_l, rect_r, block_size=block_size, min_disparity=0,
        max_disparity=max_disparity, smooth_factor=0.9,
    )
    ours = np.asarray(block_search_right(
        jnp.asarray(rect_l), jnp.asarray(rect_r),
        MatcherConfig(block_size=block_size, max_disparity=max_disparity,
                      smooth_factor=0.9, row_smooth_iters=2),
    ))
    agree = float((ours == od).mean())
    # mask out no-candidate sentinel pixels (negative values): evaldisp
    # clips the test disparity but not the GT, so exact sentinel
    # agreement would otherwise count as "bad"
    pm = evaldisp_np(ours, od.astype(np.float64),
                     np.where(od > 0, 255, 0).astype(np.uint8))
    return {
        "exact_agreement": agree,
        "bad2_vs_oracle": pm["bad_percent"],
        "seconds": round(time.time() - t0, 1),
    }


def baseline_for(pair, idx, force=False):
    """Reference reproduction, cached to baselines/."""
    from stereo_reconstruction.io.pfm import read_pfm, write_pfm

    stem = os.path.join(BASELINES, f"{pair.name}_ds1")
    pfm = stem + "_baseline_disp.pfm"
    js = stem + "_baseline.json"
    if not force and os.path.isfile(pfm) and os.path.isfile(js):
        with open(js) as f:
            rec = json.load(f)
        if "pose" in rec:
            return read_pfm(pfm), rec
    from reference_baseline import run_reference_baseline

    t0 = time.time()
    disp, pose, metrics = run_reference_baseline(pair, downsample=1, seed=0)
    rec = {"metrics": metrics, "scenario": pair.name, "pose": pose,
           "downsample": 1, "max_disparity": 100,
           "seconds": round(time.time() - t0, 1)}
    os.makedirs(BASELINES, exist_ok=True)
    write_pfm(pfm, disp.astype(np.float32))
    with open(js, "w") as f:
        json.dump(rec, f, indent=2)
    return disp, rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="/root/reference/data/MiddEval3")
    ap.add_argument("--scenes", default="",
                    help="comma-separated indices (default: all 15)")
    ap.add_argument("--configs", default="ssd,ncc")
    ap.add_argument("--out", default=os.path.join(BASELINES, "full_eval.json"))
    ap.add_argument("--force-baseline", action="store_true")
    ap.add_argument("--crop", action="store_true",
                    help="quick mode: matcher parity on a Teddy crop of the "
                         "raw (pre-rectified) pair only — seconds on CPU")
    args = ap.parse_args()

    if args.crop:
        from stereo_reconstruction.data import MiddEval3
        from stereo_reconstruction.data.middeval3 import downsample_pair

        idx = int(args.scenes) if args.scenes else 13   # Teddy
        pair = downsample_pair(MiddEval3(args.data).load_training(idx))
        L = np.asarray(pair.image_left, np.uint8)[100:180, 100:356]
        R = np.asarray(pair.image_right, np.uint8)[100:180, 100:356]
        rec = matcher_parity(L, R, max_disparity=48)
        rec["scene"], rec["git"] = pair.name, git_hash()
        print(json.dumps(rec))
        return

    from stereo_reconstruction.config import PipelineConfig
    from stereo_reconstruction.data import MiddEval3
    from stereo_reconstruction.data.middeval3 import downsample_pair
    from stereo_reconstruction.pipeline import run_pair

    ds = MiddEval3(args.data)
    n_scenes = ds.num_training
    scenes = ([int(s) for s in args.scenes.split(",") if s != ""]
              if args.scenes else list(range(n_scenes)))
    configs = args.configs.split(",")

    base = PipelineConfig()
    base = base.replace(
        matcher=dataclasses.replace(base.matcher, max_disparity=100),
        recon=dataclasses.replace(base.recon, outlier_kernel=251),
    )

    import jax

    results = {"_meta": {"git": git_hash(), "configs": configs}}
    for idx in scenes:
        # every scene has its own image shape -> its own compiles; drop the
        # previous scene's executables or LLVM section memory accumulates
        # past the allocator's limit over 15 scenes (observed OOM)
        jax.clear_caches()
        pair = downsample_pair(ds.load_training(idx))
        print(f"=== [{idx}] {pair.name} {pair.image_right.shape} ===", flush=True)
        rec = {"index": idx, "shape": list(np.asarray(pair.image_right).shape[:2])}

        t0 = time.time()
        try:
            bdisp, brec = baseline_for(pair, idx, force=args.force_baseline)
            rec["baseline"] = {"metrics_gt": brec.get("metrics") or None,
                               "pose": brec.get("pose"),
                               "cached": "seconds" not in brec or None}
        except Exception as e:  # baseline reproduction can fail like the C++
            print(f"  baseline FAILED: {e}", flush=True)
            bdisp, brec = None, None
            rec["baseline"] = {"error": str(e)}
        print(f"  baseline: {time.time()-t0:.0f}s", flush=True)

        # GT scenes: BOTH pipelines are seed-stochastic (RANSAC draws move
        # bad-2.0 by several pp on hard scenes — ArtL spans 58.4..62.6
        # over 4 seeds), so a single-draw-vs-single-draw +-0.5pp gate is
        # noise; record 3-seed MEDIANS on each side for the GT gate.
        if brec is not None and brec.get("metrics"):
            from reference_baseline import run_reference_baseline

            bb = [float(brec["metrics"]["bad_percent"])]
            for s_extra in (1, 2):
                try:
                    _, _, m_s = run_reference_baseline(
                        pair, downsample=1, seed=s_extra)
                    if m_s:
                        bb.append(float(m_s["bad_percent"]))
                except Exception as e:
                    print(f"  baseline seed {s_extra} FAILED: {e}",
                          flush=True)
            rec["baseline"]["bad2_gt_seeds"] = [round(v, 3) for v in bb]
            rec["baseline"]["bad2_gt_median"] = float(np.median(bb))
            print(f"  baseline 3-seed bad2: {rec['baseline']['bad2_gt_seeds']}"
                  f" median {rec['baseline']['bad2_gt_median']:.2f}",
                  flush=True)

        # matcher parity: identical rectified input (from the baseline's
        # pose + Loop-Zhang homographies + cv2 warps) -> our matcher vs
        # the exact reference-semantics oracle. This isolates the dense
        # matcher (BASELINE's bad-2.0-within-0.5pp contract) from pose /
        # rectification run-to-run variance.
        if brec is not None and brec.get("pose"):
            import cv2
            from stereo_reconstruction.rectify.loop_zhang import (
                loop_zhang_homographies,
            )

            F = np.asarray(brec["pose"]["F"], np.float64)
            img_l = np.asarray(pair.image_left, np.uint8)
            img_r = np.asarray(pair.image_right, np.uint8)
            homs = loop_zhang_homographies(F, img_l.shape[:2], img_r.shape[:2])
            hl, wl = homs.canvas_left
            hr, wr = homs.canvas_right
            rect_l = cv2.warpPerspective(img_l, homs.H_left, (wl, hl))
            rect_r = cv2.warpPerspective(img_r, homs.H_right, (wr, hr))
            # the reference evaluates rows < min(h1, h2) only
            # (BlockSearch.cpp height = min); crop both for the comparison
            hm = min(rect_l.shape[0], rect_r.shape[0])
            rec["matcher_parity"] = matcher_parity(rect_l[:hm], rect_r[:hm])
            print("  matcher parity: agree="
                  f"{rec['matcher_parity']['exact_agreement']:.4f} "
                  f"bad2={rec['matcher_parity']['bad2_vs_oracle']:.3f}% "
                  f"({rec['matcher_parity']['seconds']}s)", flush=True)

        # shared-pose end-to-end parity (VERDICT r4 #5): feed the SAME F
        # to both the oracle pipeline (cv2 warps + oracle matcher +
        # reference H_left back-warp + quantization) and the framework
        # pipeline (device warps + Pallas/XLA matcher, compat back-warp)
        # — deterministic given F, so the dense+rectify path is gateable
        # on ALL 15 scenes, not only the two with usable GT.
        if brec is not None and brec.get("pose"):
            from reference_baseline import reference_pipeline_from_F

            t0 = time.time()
            F = np.asarray(brec["pose"]["F"], np.float64)
            disp_oracle = reference_pipeline_from_F(
                pair, F, downsample=1, max_disparity=100, clamp=False)
            res_sp = run_pair(pair, base, fixed_F=F, png_compat=True,
                              backwarp_compat_left=True)
            ours = res_sp.disparity
            mask = np.where(disp_oracle > 0, 255, 0).astype(np.uint8)
            sp = evaldisp_np(ours, disp_oracle.astype(np.float64), mask)
            rec["shared_pose"] = {
                "bad2_vs_oracle_pipeline": round(sp["bad_percent"], 4),
                "invalid_percent": round(sp["invalid_percent"], 4),
                "avg_err": round(sp["avg_err"], 4),
                "exact_agreement": round(
                    float((ours == disp_oracle).mean()), 5),
                "seconds": round(time.time() - t0, 1),
            }
            print(f"  shared-pose: bad2={sp['bad_percent']:.3f}% "
                  f"agree={rec['shared_pose']['exact_agreement']:.4f} "
                  f"({rec['shared_pose']['seconds']}s)", flush=True)

        for cname in configs:
            cfg = base.replace(
                matcher=dataclasses.replace(base.matcher, cost=cname))
            t0 = time.time()
            try:
                res = run_pair(pair, cfg)
            except Exception as e:
                print(f"  {cname} FAILED: {e}", flush=True)
                rec[cname] = {"error": str(e)}
                continue
            entry = {
                "seconds": round(time.time() - t0, 1),
                "pose_valid": bool(res.pose.valid),
                "reproj_error_8pt": float(res.pose.reproj_error_8pt),
                "reproj_error_ba": float(res.pose.reproj_error_ba),
                "pose": np.asarray(res.pose.pose).tolist(),
                "num_inliers": int(res.pose.num_inliers),
            }
            if "bad_percent" in res.metrics:  # real GT present
                entry["metrics_gt"] = {
                    k: float(res.metrics[k])
                    for k in ("bad_percent", "invalid_percent",
                              "total_bad_percent", "avg_err")
                }
                # 3-seed median (see the baseline-side comment above)
                seeds_bad = [entry["metrics_gt"]["bad_percent"]]
                for s_extra in (1, 2):
                    try:
                        res_s = run_pair(pair, cfg.replace(seed=s_extra))
                        if "bad_percent" in res_s.metrics:
                            seeds_bad.append(
                                float(res_s.metrics["bad_percent"]))
                    except Exception as e:
                        print(f"  {cname} seed {s_extra} FAILED: {e}",
                              flush=True)
                entry["bad2_gt_seeds"] = [round(v, 3) for v in seeds_bad]
                entry["bad2_gt_median"] = float(np.median(seeds_bad))
            if bdisp is not None:
                # parity vs the reference reproduction's own output
                mask = np.where(bdisp > 0, 255, 0).astype(np.uint8)
                entry["vs_baseline"] = evaldisp_np(
                    res.disparity, bdisp.astype(np.float64), mask)
            rec[cname] = entry
            gtb = entry.get("metrics_gt", {}).get("bad_percent")
            vsb = entry.get("vs_baseline", {}).get("bad_percent")
            print(f"  {cname}: {entry['seconds']}s"
                  f" bad2_gt={gtb if gtb is None else round(gtb, 2)}"
                  f" bad2_vs_baseline={vsb if vsb is None else round(vsb, 2)}",
                  flush=True)

        results[pair.name] = rec
        with open(args.out, "w") as f:   # checkpoint after every scene
            json.dump(results, f, indent=2)

    # markdown table
    print("\n| scene | ref bad-2.0 (GT) | ssd bad-2.0 (GT) | matcher bad-2.0 "
          "vs oracle | ssd vs ref e2e | ncc vs ref e2e | ssd avgErr (GT) |")
    print("|---|---|---|---|---|---|---|")
    for name, rec in results.items():
        if name.startswith("_"):
            continue
        bm = (rec.get("baseline") or {}).get("metrics_gt") or {}
        s = rec.get("ssd", {})
        n = rec.get("ncc", {})
        sg = s.get("metrics_gt") or {}
        mp = rec.get("matcher_parity") or {}
        def fmt(v, nd=2):
            return f"{v:.{nd}f}" if isinstance(v, (int, float)) else "—"
        print(f"| {name} | {fmt(bm.get('bad_percent'))} | "
              f"{fmt(sg.get('bad_percent'))} | "
              f"{fmt(mp.get('bad2_vs_oracle'), 3)} | "
              f"{fmt((s.get('vs_baseline') or {}).get('bad_percent'))} | "
              f"{fmt((n.get('vs_baseline') or {}).get('bad_percent'))} | "
              f"{fmt(sg.get('avg_err'))} |")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
