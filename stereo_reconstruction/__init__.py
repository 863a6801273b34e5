"""stereo_reconstruction — a stereo reconstruction framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the classical two-view stereo
pipeline found in the reference C++ implementation
(Bizilizi/stereo_reconstruction): feature detection + matching, eight-point
essential-matrix pose estimation with RANSAC, Gauss-Newton/LM bundle
adjustment (Schur complement), Loop-Zhang projective rectification, dense
window-search disparity (SSD/NCC/perceptual cost volumes), disparity
post-processing, depth back-projection and mesh output.

Design stance (accelerator-first, not a port):
  * every pipeline stage is a pure, jittable function over static shapes;
  * the dense matcher is O(H*W*D) via separable window sums instead of the
    reference's O(H*W*D*B^2) scalar loops: a fused Pallas kernel on the
    GPU, plain XLA elsewhere;
  * multi-chip scaling is expressed as shardings over one
    ``jax.sharding.Mesh`` (axes ``("data", "tile")``) with XLA collectives;
  * host-side I/O (PNG/PFM/calib/OFF) stays on host, feeding padded batches.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Framework default: f32 matmuls/convs really run at f32. On a GPU, JAX's
# DEFAULT precision runs them in TF32, which keeps about three decimal
# digits, and this framework's quality claims are parity claims — the
# pose chain amplifies that noise from the descriptor Gram into a bad F
# (different matches -> F off -> curved rectified scanlines), and the
# perceptual/VGG path's notebook-exactness breaks outright. Kernels that
# want bf16 (none of the quality-critical ones do) opt in explicitly. Override: STPU_MATMUL_PRECISION=default.
# Deference: if the embedding process already configured
# jax_default_matmul_precision (flag/env/config), importing this package
# leaves that choice alone — only the quality-critical pipeline entry
# points then re-pin locally via their context managers (pipeline.py).
if _os.environ.get("STPU_MATMUL_PRECISION"):
    _jax.config.update("jax_default_matmul_precision",
                       _os.environ["STPU_MATMUL_PRECISION"])
elif _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

from stereo_reconstruction.config import PipelineConfig  # noqa: F401
