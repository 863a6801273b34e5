#!/usr/bin/env python3
"""Reproduce the reference C++ pipeline's output as the quality baseline.

The reference publishes no numbers (BASELINE.md): the operative baseline
is *its own output*. This tool reproduces the reference ``main()`` flow
(src/main.cpp:13-66) as faithfully as the environment allows, using cv2
(same SIFT/FLANN/warp implementations the reference links) and the exact
NumPy oracle for the dense matcher:

  SIFT(500, 0.01, 5) x2 -> FLANN knn2 ratio 0.7       [keypoints.cpp]
  -> unique-column filter                              [utils.cpp:50-95]
  -> sequential point-swap RANSAC over 12-pt 8-point   [eight_point.cpp:253-361]
  -> outlier filter + first-60 truncation              [pose_estimation.cpp:44-89]
  -> LM bundle adjustment (plain L2, 20 iters)         [bundle_adjustment.h; Ceres
                                                        itself is unavailable — the
                                                        framework's LM solver with
                                                        loss="l2" stands in]
  -> Loop-Zhang rectification + cv2.warpPerspective    [rectification.cpp]
  -> BlockSearch Right oracle (exact semantics)        [oracle.py]
  -> uint8 PNG round-trip, outlier clamp, evaldisp     [main.cpp:42-58]

Writes baseline disparity + metrics JSON under --out. Run on the scenes
with real GT (Teddy=13, ArtL=1).

Usage:
  PYTHONPATH= python tools/reference_baseline.py --scenario 13 --downsample 2
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from stereo_reconstruction import oracle  # noqa: E402
from stereo_reconstruction.data import MiddEval3  # noqa: E402
from stereo_reconstruction.data.middeval3 import downsample_pair  # noqa: E402
from stereo_reconstruction.io.pfm import write_pfm  # noqa: E402
from stereo_reconstruction.rectify.loop_zhang import loop_zhang_homographies  # noqa: E402


# ---------------------------------------------------------------------------
# reference eight-point machinery in NumPy f64
# ---------------------------------------------------------------------------

class ReconstructionError(RuntimeError):
    pass


def eight_point_np(kp_l, kp_r, K_l, K_r):
    """EightPointAlgorithm::run (eight_point.cpp:26-99) in f64."""
    xl = np.linalg.solve(K_l, kp_l)
    xr = np.linalg.solve(K_r, kp_r)
    n = xl.shape[1]

    chi = np.zeros((n, 9))
    for i in range(n):
        chi[i] = np.kron(xl[:, i], xr[:, i])
    _, _, Vt = np.linalg.svd(chi)
    E0 = Vt[-1].reshape(3, 3, order="F")   # Eigen column-major reshape

    U, _, Vt2 = np.linalg.svd(E0)
    if np.linalg.det(U) < 0:
        U = -U
    V = Vt2.T
    if np.linalg.det(V) < 0:
        V = -V
    sigma = np.diag([1.0, 1.0, 0.0])
    Rz = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])

    for Rzk in (Rz, Rz.T):
        R = U @ Rzk.T @ V.T
        Tsk = U @ Rzk @ sigma @ U.T
        T = np.array([-Tsk[1, 2], Tsk[0, 2], -Tsk[0, 1]])
        depths = estimate_depth_np(xl, xr, R, T)
        pts_l = xl * depths
        pts_r = R @ pts_l + T[:, None]
        if (pts_l[2] >= 0).all() and (pts_r[2] >= 0).all():
            return R, T, pts_l, pts_r
    raise ReconstructionError("Depth reconstruction failed.")


def estimate_depth_np(xl, xr, R, T):
    """estimateDepth (eight_point.cpp:120-147)."""
    n = xl.shape[1]
    M = np.zeros((3 * n, n + 1))
    for i in range(n):
        sk = _skew(xr[:, i])
        M[3 * i : 3 * i + 3, i] = sk @ R @ xl[:, i]
        M[3 * i : 3 * i + 3, n] = sk @ T
    w, v = np.linalg.eigh(M.T @ M)
    vec = v[:, 0]
    return vec[:n] / vec[n]


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def reference_ransac(kp_l, kp_r, K_l, K_r, rng, max_iter=100, n_pts=12,
                     n_shuffle=1, thresh=4.0):
    """Literal port of RANSAC (eight_point.cpp:253-361)."""
    n = kp_l.shape[1]

    def run_subset(idx):
        R, T, pts_l, pts_r = eight_point_np(kp_l[:, idx], kp_r[:, idx], K_l, K_r)
        proj = (K_r @ pts_r) / pts_r[2]
        err = np.linalg.norm(proj[:2] - kp_r[:2, idx], axis=0)
        return R, T, err

    # initial set: retry until avg error < 3*thresh
    avg = 1e9
    guard = 0
    while avg > thresh * 3:
        guard += 1
        if guard > 500:
            raise ReconstructionError("no valid initial set")
        idx = rng.permutation(n)[:n_pts]
        try:
            R, T, err = run_subset(idx)
        except ReconstructionError:
            continue
        avg = err.sum() / n_pts

    best_err = avg
    best_idx = idx.copy()
    always_exclude: list[int] = []
    latest: list[int] = []

    for _ in range(max_iter):
        if n - len(always_exclude) <= n_pts:
            break
        idx = np.sort(idx)
        try:
            R, T, err = run_subset(idx)
        except ReconstructionError:
            always_exclude.extend(latest)
            idx, latest = _resample(idx, n, n_pts, n_shuffle, always_exclude, rng)
            continue
        best_idx = idx.copy()
        cur = err.sum() / n_pts
        if (err < thresh).all():
            return run_subset(idx)[:2] + (idx,)
        if cur > best_err:
            always_exclude.extend(latest)
            idx, latest = _resample(idx, n, n_pts, n_shuffle, always_exclude, rng)
        else:
            best_err = cur
            best_idx = idx.copy()
            worst = idx[np.argsort(-err)[:n_shuffle]]
            excl = list(worst) + always_exclude
            idx, latest = _resample(idx, n, n_pts, n_shuffle, excl, rng)

    R, T, _ = run_subset(best_idx)
    return R, T, best_idx


def _resample(idx, n, n_pts, n_shuffle, exclude, rng):
    keep = [i for i in idx if i not in exclude][: n_pts - n_shuffle]
    pool = [i for i in range(n) if i not in exclude and i not in keep]
    new = list(rng.permutation(pool)[:n_pts - len(keep)])
    return np.array(keep + new), new


# ---------------------------------------------------------------------------


def reference_pipeline_from_F(pair, F, downsample: int = 1,
                              max_disparity: int = 100, clamp: bool = True):
    """The reference pipeline DOWNSTREAM of pose, from a given F:
    Loop-Zhang + cv2 warps (rectification.cpp) -> exact-semantics
    BlockSearch Right (oracle) -> H_left-inverse NN back-warp
    (rectification.cpp:78-88, the reference's left-homography quirk kept
    for fidelity) -> uint8 PNG round-trip (main.cpp:42-50) -> outlier
    clamp (reconstruction.cpp:5-18). Deterministic given F — the
    shared-pose parity gate (VERDICT r4 #5) feeds ONE F to this and to
    the framework pipeline so dense+rectify+recon parity is seed-free."""
    import cv2

    img_l = np.asarray(pair.image_left, np.uint8)
    img_r = np.asarray(pair.image_right, np.uint8)

    homs = loop_zhang_homographies(F, img_l.shape[:2], img_r.shape[:2])
    hl, wl = homs.canvas_left
    hr, wr = homs.canvas_right
    rect_l = cv2.warpPerspective(img_l, homs.H_left, (wl, hl))
    rect_r = cv2.warpPerspective(img_r, homs.H_right, (wr, hr))

    disp_rect = oracle.block_search_right_fast(
        rect_l, rect_r, block_size=17, min_disparity=0,
        max_disparity=max_disparity, smooth_factor=0.9,
    )

    disp = cv2.warpPerspective(
        disp_rect, np.linalg.inv(homs.H_left),
        (img_r.shape[1], img_r.shape[0]), flags=cv2.INTER_NEAREST,
    )
    disp = np.clip(np.round(disp), 0, 255).astype(np.uint8).astype(np.float32)

    if not clamp:          # pre-clamp output: the dense+warp parity probe
        return disp
    kernel = max(31, 500 >> downsample)
    return oracle.remove_disparity_outliers(disp, kernel, 1.5, 0.8)


def run_reference_baseline(pair, downsample: int, max_disparity: int = 0,
                           seed: int = 0, skip_ba: bool = False):
    """Reproduce the reference main() flow on an (already downsampled)
    pair; returns (disparity, pose dict, metrics dict)."""
    import cv2

    img_l = np.asarray(pair.image_left, np.uint8)
    img_r = np.asarray(pair.image_right, np.uint8)
    K_l = np.asarray(pair.intrinsics_left, np.float64)
    K_r = np.asarray(pair.intrinsics_right, np.float64)
    max_disp = max_disparity or max(40, 200 >> downsample)

    # 1) SIFT + FLANN (keypoints.cpp:12-32); cv2 wants BGR like the reference
    sift = cv2.SIFT_create(500, 3, 0.01, 5)
    kpl, dl = sift.detectAndCompute(img_l[..., ::-1], None)
    kpr, dr = sift.detectAndCompute(img_r[..., ::-1], None)
    flann = cv2.FlannBasedMatcher()
    knn = flann.knnMatch(dl, dr, k=2)
    matches = [m for m, m2 in knn if m.distance < 0.7 * m2.distance]
    print(f"SIFT matches after ratio: {len(matches)}")

    kp_l = np.array([[*kpl[m.queryIdx].pt, 1.0] for m in matches]).T
    kp_r = np.array([[*kpr[m.trainIdx].pt, 1.0] for m in matches]).T
    # unique-column filter (utils.cpp:77-95)
    keep = []
    for i in range(kp_l.shape[1]):
        if all(np.linalg.norm(kp_l[:, i] - kp_l[:, j]) >= 1e-4 for j in keep):
            keep.append(i)
    kp_l, kp_r = kp_l[:, keep], kp_r[:, keep]
    n = kp_l.shape[1]
    print(f"unique matches: {n}")

    # 2) RANSAC 8pt (eight_point.cpp)
    rng = np.random.default_rng(seed)
    R, T, _ = reference_ransac(kp_l, kp_r, K_l, K_r, rng)

    # 3) filter + first-60 + BA (pose_estimation.cpp:44-93)
    xl = np.linalg.solve(K_l, kp_l)
    xr = np.linalg.solve(K_r, kp_r)
    depths = estimate_depth_np(xl, xr, R, T)
    pts_l = xl * depths
    pts_r = R @ pts_l + T[:, None]
    proj = (K_r @ pts_r) / pts_r[2]
    err = np.linalg.norm(proj[:2] - kp_r[:2], axis=0)
    mask = (err <= 2 * err.mean()) & (depths >= 0)
    sel = np.where(mask)[0][:60]
    print(f"survivors: {mask.sum()} -> BA on {len(sel)}")

    F = None
    if len(sel) >= 8 and not skip_ba:
        os.environ["JAX_PLATFORMS"] = os.environ.get("STPU_BASELINE_PLATFORM", "cpu")
        import dataclasses
        import jax.numpy as jnp

        from stereo_reconstruction.config import BundleAdjustmentConfig
        from stereo_reconstruction.pose.ba import bundle_adjust

        res = bundle_adjust(
            jnp.asarray(kp_l[:, sel], jnp.float32),
            jnp.asarray(kp_r[:, sel], jnp.float32),
            jnp.asarray(K_l, jnp.float32),
            jnp.asarray(K_r, jnp.float32),
            jnp.asarray(R, jnp.float32),
            jnp.asarray(T, jnp.float32),
            jnp.asarray(pts_l[:, sel], jnp.float32),
            config=BundleAdjustmentConfig(loss="l2"),   # Ceres parity
        )
        F = np.asarray(res.fundamental, np.float64)
        print(f"BA cost {float(res.initial_cost):.2f} -> {float(res.final_cost):.2f}")
    else:
        E = _skew(T) @ R
        F = np.linalg.inv(K_r).T @ E @ np.linalg.inv(K_l)
        F = F / np.linalg.norm(F)

    disp = reference_pipeline_from_F(pair, F, downsample, max_disp)

    # 8) evaldisp vs GT (utils.cpp:123-168)
    metrics = {}
    if pair.disp_right_gt is not None and pair.mask_right_nocc is not None:
        metrics = _evaldisp_np(
            disp, np.asarray(pair.disp_right_gt), np.asarray(pair.mask_right_nocc),
            2.0, float(pair.ndisp or 1e9),
        )
        print("metrics:", json.dumps(metrics, indent=2))

    pose = {"R": R.tolist(), "T": T.tolist(), "F": F.tolist(),
            "n_matches": int(n), "n_ba": int(len(sel))}
    return disp, pose, metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="/root/reference/data/MiddEval3")
    ap.add_argument("--scenario", type=int, default=13)
    ap.add_argument("--downsample", type=int, default=1,
                    help="halvings (1 = quarter res from trainingH)")
    ap.add_argument("--max-disparity", type=int, default=0,
                    help="0 = scale the reference's 200 by the downsample")
    ap.add_argument("--out", default="results/baseline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-ba", action="store_true")
    args = ap.parse_args()

    ds = MiddEval3(args.data)
    pair = ds.load_training(args.scenario)
    for _ in range(args.downsample):
        pair = downsample_pair(pair)

    disp, pose, metrics = run_reference_baseline(
        pair, args.downsample, args.max_disparity, args.seed, args.skip_ba,
    )

    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"{pair.name}_ds{args.downsample}")
    write_pfm(stem + "_baseline_disp.pfm", disp.astype(np.float32))
    with open(stem + "_baseline.json", "w") as f:
        json.dump({"metrics": metrics, "scenario": pair.name, "pose": pose,
                   "downsample": args.downsample,
                   "max_disparity": args.max_disparity or max(40, 200 >> args.downsample)},
                  f, indent=2)
    print("wrote", stem + "_baseline_disp.pfm")


def _evaldisp_np(disp, gt, mask, badthresh, maxdisp):
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
        "n_evaluated": n,
        "bad_percent": 100.0 * bad / max(n, 1),
        "invalid_percent": 100.0 * (n - n_valid) / max(n, 1),
        "total_bad_percent": 100.0 * (bad + n - n_valid) / max(n, 1),
        "avg_err": serr / max(n_valid, 1),
    }


if __name__ == "__main__":
    main()
