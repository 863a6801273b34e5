"""Configuration tree for the stereo pipeline.

The reference implementation has no config system: every hyperparameter is a
``#define``, a default argument, or a hard-coded literal (see e.g.
reference ``src/PoseEstimation/keypoints.h:5``, ``src/main.cpp:40``,
``src/PoseEstimation/eight_point.cpp:256-259``). This module is the single
place those values live; the defaults below reproduce the reference's
behavior.

All configs are frozen dataclasses so they can be used as static (hashable)
arguments to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Feature detection + matching (reference keypoints.h:5,19,30)."""

    max_keypoints: int = 500          # N_KEYPOINTS_SIFT
    num_octaves: int = 4
    scales_per_octave: int = 3
    contrast_threshold: float = 0.01  # SIFTKeypointDetection default
    edge_threshold: float = 5.0       # SIFTKeypointDetection default
    init_sigma: float = 1.6
    ratio_threshold: float = 0.7      # Lowe ratio (featureMatching default)
    mutual_check: bool = True


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB-style binary frontend for the uncalibrated path (reference
    rectification_main.cpp:33-44: cv::ORB::create(500, 1.2f, 4, 21, 0, 2,
    HARRIS_SCORE, 21, 20))."""

    max_keypoints: int = 500          # nfeatures
    scale_factor: float = 1.2         # pyramid scaleFactor
    num_levels: int = 4               # nlevels
    edge_margin: int = 21             # edgeThreshold (border margin, px)
    fast_threshold: float = 20.0      # fastThreshold (intensity DN)
    fast_arc: int = 9                 # FAST-9/16 contiguous-arc length
    harris_k: float = 0.04            # HARRIS_SCORE k
    patch_size: int = 21              # patchSize (orientation + BRIEF)
    num_bits: int = 256               # BRIEF descriptor length (WTA_K=2)


@dataclasses.dataclass(frozen=True)
class BriskConfig:
    """BRISK-style binary frontend — the reference's alternative detector
    (rectification_main.cpp:46-51: cv::BRISK::create(30, 3, 1.0f)).

    Scale space is the BRISK octave/intra-octave ladder (scales 2^i and
    1.5*2^i); saliency is the FAST score (largest threshold at which the
    segment test still fires). The descriptor is the paper's concentric
    ring pattern: 60 Gaussian-smoothed samples, long-distance pairs vote
    the orientation, short-distance pairs form the bitstring. Deviations
    from cv::BRISK (documented in PARITY.md): no continuous-scale
    parabola refinement — layer-local 3x3 NMS + global top-K saliency
    selection, same policy as the ORB path."""

    max_keypoints: int = 500
    threshold: float = 30.0           # AGAST/FAST threshold (DN)
    octaves: int = 3                  # cv::BRISK octaves
    pattern_scale: float = 1.0        # cv::BRISK patternScale
    fast_arc: int = 9                 # contiguous-arc length (FAST-9/16)
    # pattern extent 9.18 + 3*sigma_max (3*1.44 = 4.31) + FAST radius 3
    # = 16.5 -> 17, so the outermost ring samples of margin-adjacent
    # keypoints stay clear of the border-clipped blur region (ADVICE r4)
    edge_margin: int = 17
    max_bits: int = 512               # cap on short-pair descriptor bits


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Parallel-hypothesis RANSAC for the eight-point solve.

    The reference (eight_point.cpp:253-361) runs a sequential point-swap
    refinement over 12-point samples with a 4 px accept threshold; here the
    same accept thresholds drive K vmapped hypotheses scored in parallel.
    """

    num_hypotheses: int = 256         # replaces maxIter=100 sequential trips
                                      # (vmapped 8pt solves are cheap; 256
                                      # de-noises the sample lottery)
    # minimal samples maximize the clean-sample rate for parallel RANSAC
    # (the reference's 12-point N_KEYPOINTS_8PT, eight_point.cpp:11, suits
    # its sequential point-swap refinement instead)
    sample_size: int = 8
    error_threshold: float = 4.0      # errorThreshold (eight_point.cpp:259)
    init_error_factor: float = 3.0    # initial accept = 3 * threshold (:268)
    refine_rounds: int = 2            # refit-on-tightest-inlier polish rounds
    refine_support: int = 16          # matches used per refit


@dataclasses.dataclass(frozen=True)
class BundleAdjustmentConfig:
    """LM bundle adjustment (reference bundle_adjustment.h:264-272).

    The 60-point cap in the reference is a Ceres template-arity artifact
    (bundle_adjustment.h:12,165); this solver takes any static point count.
    ``num_points`` only controls the padded problem size fed by the pose
    pipeline (compat default 60).
    """

    max_iterations: int = 20
    num_points: int = 60
    # "l2" matches the reference's plain squared loss
    # (bundle_adjustment.h:254-259 passes a nullptr loss function);
    # "huber" adds IRLS robust weighting — an improvement the reference
    # lacks, used by the default pipeline against residual outliers.
    loss: str = "huber"
    huber_delta: float = 2.0          # px
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    min_lambda: float = 1e-9
    max_lambda: float = 1e6


@dataclasses.dataclass(frozen=True)
class RectifyConfig:
    """Loop-Zhang rectification (reference rectification.cpp:53-64)."""

    newton_iterations: int = 150      # z_optimization.hpp:141
    newton_tolerance: float = 1e-15
    # Static padded canvas budget: rectified canvases in the reference are
    # data-dependent (rectification.cpp:437-480); under jit we warp into a
    # fixed canvas scaled from the input size by this factor.
    canvas_scale: float = 1.5


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Dense window-search disparity (reference BlockSearch + main.cpp:40)."""

    block_size: int = 17
    min_disparity: int = 0
    max_disparity: int = 200
    smooth_factor: float = 0.9
    cost: str = "ssd"                 # "ssd" | "sad" | "ncc" | "perceptual"
    # dense matcher backend, resolved in one place
    # (ops/pallas_cost_volume.py use_kernel): "pallas" = the fused GPU
    # kernel (raises where it cannot compile), "xla" = the cost volume from
    # separable reduce_window planes (ops/cost_volume.py), "auto" = the
    # kernel on a GPU for the configurations it covers, xla otherwise. The
    # two agree bit-for-bit on integer-valued images
    # (tests/test_pallas_cost_volume.py).
    backend: str = "auto"
    # variable-window mode (BlockSearch.cpp:129-142): grow block while
    # window texture ||win - mean|| < texture_threshold. This version selects
    # among a bounded set of block sizes by texture mask.
    var_block: bool = False
    texture_threshold: float = 19.0   # BlockSearch.h default thres
    var_block_sizes: Tuple[int, ...] = (17, 21, 25)
    # number of refinement sweeps approximating the reference's in-row
    # sequential left-neighbor smoothing term (see ops/smoothing.py)
    row_smooth_iters: int = 2


@dataclasses.dataclass(frozen=True)
class PerceptualConfig:
    """VGG/LPIPS feature cost (reference notebook cells 6-10)."""

    window_size: int = 17
    padding: int = 8
    max_disparity: int = 200
    smoothing_bias: float = 0.85
    smoothing_sigma: float = 25.0
    weights_path: str = ""            # optional LPIPS/VGG weight file (.npz)
    # "windowed" = per-window VGG embeddings, the notebook's exact
    # semantics batched into wide matmuls (perceptual/cost.py
    # windowed_lpips_search); "full_image" = shared full-image feature
    # approximation (~10x fewer FLOPs, structural receptive-field gap)
    mode: str = "windowed"
    chunk: int = 20                   # notebook cell 10 size_of_chunk
    # rows per conv batch in the windowed cost volume (row_block * W
    # windows per conv batch; purely a throughput knob — per-window math
    # is independent, so results are row-identical for any value)
    row_block: int = 8


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    """Disparity post-processing + meshing (reference main.cpp:53-65)."""

    outlier_kernel: int = 500         # removeDisparityOutliers kernel
    outlier_front: float = 1.5
    outlier_back: float = 0.8
    baseline: float = 1.0             # main.cpp:57 (normalized extrinsics)
    mesh_edge_threshold: float = 1.0  # thrMesh (main.cpp:64)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh layout for multi-chip runs."""

    data_axis: str = "data"           # batch of stereo pairs
    tile_axis: str = "tile"           # cost-volume row tiles
    data_parallel: int = 1
    tile_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    frontend: FrontendConfig = FrontendConfig()
    orb: OrbConfig = OrbConfig()
    brisk: BriskConfig = BriskConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BundleAdjustmentConfig = BundleAdjustmentConfig()
    rectify: RectifyConfig = RectifyConfig()
    matcher: MatcherConfig = MatcherConfig()
    perceptual: PerceptualConfig = PerceptualConfig()
    recon: ReconConfig = ReconConfig()
    sharding: ShardingConfig = ShardingConfig()
    seed: int = 0

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
