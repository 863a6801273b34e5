"""End-to-end stereo reconstruction pipeline.

The framework's equivalent of the reference ``main()``
(``src/main.cpp:13-66``): pose estimation -> rectification -> dense
disparity -> post-processing -> depth -> mesh — plus staged artifacts so
every stage is resumable (the reference stages through
``results/disparity_map.png``; we stage float PFMs + JSON and keep the
uint8 PNG round-trip as a compat option, since it quantizes disparity).

Stage boundary layout:
  host: feature/pose orchestration glue, Loop-Zhang homographies (tiny
        3x3 float64 math), artifact I/O;
  device (jit): feature detection, descriptor matching, RANSAC 8pt, BA,
        warps, cost volume + smoothing argmin, disparity post-processing,
        back-projection.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.config import PipelineConfig
from stereo_reconstruction.data.records import StereoPair
from stereo_reconstruction.io.image import disparity_png_roundtrip
from stereo_reconstruction.io.pfm import write_pfm
from stereo_reconstruction.ops import metrics as metrics_mod
from stereo_reconstruction.ops.block_search import block_search_right
from stereo_reconstruction.ops.features import detect_and_describe
from stereo_reconstruction.ops.matching import (
    match_descriptors,
    matches_to_homogeneous,
)
from stereo_reconstruction.pose.pipeline import (
    PoseEstimate,
    estimate_pose_from_matches,
)
from stereo_reconstruction.recon.backproject import backproject
from stereo_reconstruction.recon.disparity import (
    disparity_to_depth,
    remove_disparity_outliers,
)
from stereo_reconstruction.recon.meshing import save_mesh
from stereo_reconstruction.rectify.rectifier import (
    disparity_to_original_frame,
    rectify_pair,
)


@dataclasses.dataclass
class PipelineResult:
    pose: Optional[PoseEstimate]
    disparity: np.ndarray            # (H, W) right-image disparity, original frame
    depth: Optional[np.ndarray]
    metrics: Dict[str, float]
    timings: Dict[str, float]


@functools.partial(jax.jit, static_argnames=("config",))
def _pose_device(key, image_left, image_right, K_left, K_right,
                 config: PipelineConfig) -> PoseEstimate:
    """The whole sparse-pose stage as ONE device program: SIFT x2 ->
    match -> on-device valid-compaction -> RANSAC 8pt -> filter -> BA.
    One host->device call instead of five, and no per-scene recompile (the
    valid-match count is a traced scalar, not a static shape)."""
    # The whole stage traces under HIGHEST matmul precision: on a GPU the
    # default runs f32 matmuls/convs in TF32 (about three decimal digits),
    # and the pose chain amplifies that noise (descriptor Gram ->
    # different matches -> F off -> rectified scanlines curve -> dense
    # matching degrades). The fused dense kernel pins its own precision;
    # this pins the sparse stage.
    with jax.default_matmul_precision("highest"):
        # both images through ONE vmapped detector program: halves
        # dispatch count and lets XLA schedule the two pyramids together
        # (the SIFT stage dominates — baselines/pose_profile.json)
        kp_pair = jax.vmap(
            lambda img: detect_and_describe(img, config.frontend)
        )(jnp.stack([image_left, image_right]))
        kp_l = jax.tree.map(lambda x: x[0], kp_pair)
        kp_r = jax.tree.map(lambda x: x[1], kp_pair)
        matches = match_descriptors(kp_l, kp_r, config.frontend)
        ml, mr, valid = matches_to_homogeneous(matches)

        # compact valid matches to the front (stable: original order kept)
        order = jnp.argsort(jnp.logical_not(valid), stable=True)
        ml = ml[:, order]
        mr = mr[:, order]
        n_valid = jnp.sum(valid)

        return estimate_pose_from_matches(
            key, ml, mr, K_left, K_right, config, num_matches_valid=n_valid,
        )


def estimate_pose(pair: StereoPair, config: PipelineConfig, key=None) -> PoseEstimate:
    """SIFT x2 -> match -> RANSAC 8pt -> filter -> BA
    (reference runFullPoseEstimation, pose_estimation.cpp:4-115)."""
    key = jax.random.key(config.seed) if key is None else key
    return _pose_device(
        key,
        jnp.asarray(pair.image_left),
        jnp.asarray(pair.image_right),
        jnp.asarray(pair.intrinsics_left),
        jnp.asarray(pair.intrinsics_right),
        config,
    )


def compute_disparity(left, right, config: PipelineConfig) -> jnp.ndarray:
    """Dense right-image disparity on a rectified pair, dispatched on
    ``config.matcher.cost``: the window-search matcher (ssd/sad/ncc,
    reference BlockSearch.cpp:88-179) or the perceptual LPIPS search
    (reference notebook cells 6-10, BASELINE config 3)."""
    if config.matcher.cost == "perceptual":
        from stereo_reconstruction.perceptual import (
            get_params,
            perceptual_window_search,
        )

        pcfg = dataclasses.replace(
            config.perceptual, max_disparity=config.matcher.max_disparity
        )
        params = get_params(pcfg.weights_path, seed=config.seed)
        return perceptual_window_search(params, left, right, pcfg)
    return block_search_right(left, right, config.matcher)


def run_pair(
    pair: StereoPair,
    config: PipelineConfig = PipelineConfig(),
    output_dir: Optional[str] = None,
    write_mesh: bool = False,
    png_compat: bool = False,
    fixed_F: Optional[np.ndarray] = None,
    backwarp_compat_left: bool = False,
) -> PipelineResult:
    """Full reconstruction of one stereo pair (reference main.cpp flow).

    ``fixed_F``: skip pose estimation and rectify from this fundamental
    matrix — the shared-pose parity mode (VERDICT r4 #5: one F feeds both
    this pipeline and the oracle pipeline, so dense+rectify+recon parity
    is seed-free). ``backwarp_compat_left`` back-warps disparity with the
    LEFT homography like the reference (rectification.cpp:78-88 quirk)
    instead of the corrected right one."""
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()

    if fixed_F is None:
        pose = estimate_pose(pair, config)
        jax.block_until_ready(pose.pose)
    else:
        pose = None
    timings["pose"] = time.perf_counter() - t0

    # failure recovery (SURVEY §5: per-pair failure masking instead of the
    # reference's throws, pose_estimation.cpp:84): a degenerate pose
    # (non-finite reprojection error / cheirality failure) would rectify
    # the pair into garbage — match the raw pair instead. MiddEval3 pairs
    # are row-aligned already, so the degraded mode stays meaningful.
    pose_ok = fixed_F is not None or (
        bool(pose.valid) and float(pose.reproj_error_ba) < 50.0)

    t0 = time.perf_counter()
    if pose_ok:
        F = (np.asarray(fixed_F, np.float64) if fixed_F is not None
             else np.asarray(pose.fundamental, np.float64))
        rect = rectify_pair(
            jnp.asarray(pair.image_left),
            jnp.asarray(pair.image_right),
            F,
            config=config.rectify,
        )
        jax.block_until_ready(rect.right)
    else:
        F = np.eye(3)
        rect = None
    timings["rectify"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if pose_ok:
        disp_rect = compute_disparity(rect.left, rect.right, config)
        disparity = disparity_to_original_frame(
            disp_rect,
            rect.homographies.H_right,
            (pair.height, pair.width),
            compat_left_homography=(rect.homographies.H_left
                                    if backwarp_compat_left else None),
        )
    else:
        disparity = compute_disparity(
            jnp.asarray(pair.image_left, jnp.float32),
            jnp.asarray(pair.image_right, jnp.float32),
            config,
        )
    jax.block_until_ready(disparity)
    timings["disparity"] = time.perf_counter() - t0

    disparity_np = np.asarray(disparity)
    if png_compat:
        # reference main.cpp:42,50 quantizes through a uint8 PNG
        disparity_np = disparity_png_roundtrip(disparity_np)

    t0 = time.perf_counter()
    disp_clean = remove_disparity_outliers(
        jnp.asarray(disparity_np),
        config.recon.outlier_kernel,
        config.recon.outlier_front,
        config.recon.outlier_back,
    )
    focal = float(np.asarray(pair.intrinsics_right)[0, 0])
    depth = disparity_to_depth(disp_clean, focal, config.recon.baseline)
    grid = backproject(jnp.asarray(pair.image_right), depth, jnp.asarray(pair.intrinsics_right))
    jax.block_until_ready(depth)
    timings["recon"] = time.perf_counter() - t0

    results: Dict[str, float] = {"pose_ok": float(pose_ok)}
    if pose is not None:
        results.update({
            "reproj_error_8pt": float(pose.reproj_error_8pt),
            "reproj_error_ba": float(pose.reproj_error_ba),
            "num_inliers": int(pose.num_inliers),
        })
    if pair.disp_right_gt is not None and pair.mask_right_nocc is not None:
        m = metrics_mod.evaldisp(
            jnp.asarray(disparity_np),
            jnp.asarray(pair.disp_right_gt),
            jnp.asarray(pair.mask_right_nocc),
            bad_thresh=2.0,
            max_disp=float(pair.ndisp or 1e9),
        )
        results.update({k: float(v) for k, v in m.items()})

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        stem = os.path.join(output_dir, pair.name or "pair")
        write_pfm(stem + "_disp.pfm", disparity_np.astype(np.float32))
        with open(stem + "_pose.json", "w") as f:
            json.dump(
                {
                    "pose": (np.asarray(pose.pose).tolist()
                             if pose is not None else None),
                    "fundamental": F.tolist(),
                    "metrics": results,
                    "timings": timings,
                },
                f,
                indent=2,
            )
        if write_mesh:
            save_mesh(stem + "_mesh.off", grid, config.recon.mesh_edge_threshold)

    return PipelineResult(
        pose=pose,
        disparity=disparity_np,
        depth=np.asarray(depth),
        metrics=results,
        timings=timings,
    )


def reconstruct_from_disparity(
    pair: StereoPair,
    disparity: np.ndarray,
    config: PipelineConfig = PipelineConfig(),
    output_path: Optional[str] = None,
):
    """The reference's RUN_ALL=0 path (main.cpp:11,46-65): reconstruct from
    a precomputed disparity map (HitNet / perceptual) through the same
    backend."""
    disp_clean = remove_disparity_outliers(
        jnp.asarray(disparity),
        config.recon.outlier_kernel,
        config.recon.outlier_front,
        config.recon.outlier_back,
    )
    focal = float(np.asarray(pair.intrinsics_right)[0, 0])
    depth = disparity_to_depth(disp_clean, focal, config.recon.baseline)
    grid = backproject(
        jnp.asarray(pair.image_right), depth, jnp.asarray(pair.intrinsics_right)
    )
    if output_path:
        save_mesh(output_path, grid, config.recon.mesh_edge_threshold)
    return grid, np.asarray(depth)
