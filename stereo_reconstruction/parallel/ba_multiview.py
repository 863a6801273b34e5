"""Multi-view bundle adjustment: M cameras, distributed Schur complement.

BASELINE config 5 ("pose estimation + distributed Schur-BA over an image
sequence, fused point cloud across N hosts"): this scales the reference's
two-view Ceres problem (``src/PoseEstimation/bundle_adjustment.h:205-230``,
one pose + 60 points) to

  * M cameras — camera 0 is the gauge (fixed at identity), cameras 1..M-1
    carry 6-DoF angle-axis+translation parameters;
  * N 3D points with per-observation weights (w[m, n] = 0 encodes "point n
    not observed by camera m", so sparse tracks ride a dense layout);
  * Levenberg-Marquardt over the joint problem, with the point blocks
    eliminated analytically: the reduced camera system is the 6M x 6M
    Schur complement  S = B - sum_n E_n C_n^{-1} E_n^T  where B is the
    block-diagonal camera Hessian, E_n the (6M, 3) camera-point coupling
    of point n and C_n its 3x3 point Hessian;
  * points are sharded over the mesh: every device eliminates its local
    point blocks and the reduced system (S, rhs) — O(36 M^2) floats — is
    ``psum``-ed across all mesh axes (the only collective per iteration),
    exactly the pattern of parallel/ba_dist.py generalized to M poses.
    Back-substitution of the point updates stays local to each shard.

``fuse_point_cloud`` all_gathers the optimized point shards so every
device (host) holds the full fused cloud — the cross-host "fusion" step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stereo_reconstruction.config import BundleAdjustmentConfig
from stereo_reconstruction.ops import geometry as geo


class MultiViewBAResult(NamedTuple):
    poses: jnp.ndarray          # (M, 6) angle-axis + translation (cam 0 = 0)
    pose_matrices: jnp.ndarray  # (M, 4, 4) world(cam0) -> camera m
    points: jnp.ndarray         # (N, 3) optimized 3D points, world frame
    initial_cost: jnp.ndarray   # () weighted sum of squared residuals
    final_cost: jnp.ndarray


def _project_residual(pose6, X, obs, K):
    """(2,) reprojection residual of point X in the camera at pose6.

    Same semantics as the reference's BundleAdjustmentConstraint
    (bundle_adjustment.h:134-161) generalized to any camera: transform by
    the camera pose, project with K, subtract the observation.
    """
    R = geo.angle_axis_to_rotation(pose6[:3])
    Xc = R @ X + pose6[3:]
    p = K @ Xc
    p = p / p[2]
    return obs - p[:2]


def _build_normal_blocks(poses, X_blk, obs_blk, w_blk, Ks, cam_mask):
    """Per-shard Hessian blocks for the reduced camera system.

    Returns (B, v, E, C, g): B (M,6,6) block-diag camera Hessian summed
    over local points, v (M,6) camera gradient, E (Nl,M,6,3) couplings,
    C (Nl,3,3) point Hessians, g (Nl,3) point gradients.
    """
    def res_one(pose6, x, o, K):
        return _project_residual(pose6, x, o, K)

    # residuals + Jacobians for every (camera, local point) pair
    def per_point(x, obs_m, w_m):
        def per_cam(pose6, o, K, wm, cmask):
            r = res_one(pose6, x, o, K)
            Jp = jax.jacfwd(lambda q: res_one(q, x, o, K))(pose6)   # (2, 6)
            Jx = jax.jacfwd(lambda xx: res_one(pose6, xx, o, K))(x)  # (2, 3)
            w = wm
            return r * w, Jp * (w * cmask), Jx * w
        return jax.vmap(per_cam)(poses, obs_m, Ks, w_m, cam_mask)

    r, Jp, Jx = jax.vmap(per_point)(X_blk, obs_blk, w_blk)
    # r (Nl, M, 2), Jp (Nl, M, 2, 6) — gauge camera rows zeroed, Jx (Nl, M, 2, 3)

    B = jnp.einsum("nmri,nmrj->mij", Jp, Jp)          # (M, 6, 6)
    v = -jnp.einsum("nmri,nmr->mi", Jp, r)            # (M, 6)
    E = jnp.einsum("nmri,nmrj->nmij", Jp, Jx)         # (Nl, M, 6, 3)
    C = jnp.einsum("nmri,nmrj->nij", Jx, Jx)          # (Nl, 3, 3)
    g = -jnp.einsum("nmri,nmr->ni", Jx, r)            # (Nl, 3)
    return B, v, E, C, g, r


def _lm_core(poses0, X0_blk, obs_blk, w_blk, Ks, config, psum_fn):
    """Shared LM loop; psum_fn reduces shard-local sums (identity on one
    device)."""
    M = poses0.shape[0]
    cam_mask = (jnp.arange(M) > 0).astype(jnp.float32)   # camera 0 = gauge

    def cost(poses, X_blk):
        def per_point(x, obs_m, w_m):
            def per_cam(pose6, o, K, wm):
                r = _project_residual(pose6, x, o, K)
                return jnp.sum(r * r) * wm * wm
            return jnp.sum(jax.vmap(per_cam)(poses, obs_m, Ks, w_m))
        return psum_fn(jnp.sum(jax.vmap(per_point)(X_blk, obs_blk, w_blk)))

    def lm_step(state, _):
        poses, X_blk, lam, current_cost = state
        B, v, E, C, g, _ = _build_normal_blocks(
            poses, X_blk, obs_blk, w_blk, Ks, cam_mask
        )

        C_inv = jnp.linalg.inv(C + lam * jnp.eye(3)[None])       # (Nl, 3, 3)
        EC = jnp.einsum("nmij,njk->nmik", E, C_inv)              # (Nl, M, 6, 3)
        # S[m, m'] -= sum_n EC[n, m] @ E[n, m']^T  — full 6M x 6M coupling
        S_off = jnp.einsum("nmik,npjk->mipj", EC, E)             # (M, 6, M, 6)
        S = (
            _block_diag_expand(B, M)
            - S_off.reshape(6 * M, 6 * M)
        )
        rhs = (v - jnp.einsum("nmij,nj->mi", EC, g)).reshape(6 * M)

        # one packed psum per LM step (36M^2 + 6M floats) — a single
        # collective phase instead of two on latency-bound fabrics
        packed = psum_fn(jnp.concatenate([S.reshape(-1), rhs]))
        S = packed[: 36 * M * M].reshape(6 * M, 6 * M)
        rhs = packed[36 * M * M:]

        # gauge: pin camera 0 (unit diagonal, zero rhs) + LM damping
        diag_fix = jnp.concatenate(
            [jnp.ones(6), jnp.zeros(6 * (M - 1))]
        )
        S = S + jnp.diag(diag_fix) + lam * jnp.eye(6 * M)
        rhs = rhs * jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (M - 1))])

        d_cam = jnp.linalg.solve(S, rhs).reshape(M, 6)
        d_cam = d_cam * (jnp.arange(M) > 0)[:, None]

        # back-substitute local point updates
        Ed = jnp.einsum("nmij,mi->nj", E, d_cam)                 # (Nl, 3)
        d_X = jnp.einsum("nij,nj->ni", C_inv, g - Ed)

        new_poses = poses + d_cam
        new_X = X_blk + d_X
        new_cost = cost(new_poses, new_X)
        accept = new_cost < current_cost
        poses = jnp.where(accept, new_poses, poses)
        X_blk = jnp.where(accept, new_X, X_blk)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * config.lambda_down, config.min_lambda),
            jnp.minimum(lam * config.lambda_up, config.max_lambda),
        )
        current_cost = jnp.where(accept, new_cost, current_cost)
        return (poses, X_blk, lam, current_cost), None

    c0 = cost(poses0, X0_blk)
    init = (poses0, X0_blk, jnp.asarray(config.init_lambda, jnp.float32), c0)
    (poses_f, X_f, _, cost_f), _ = lax.scan(
        lm_step, init, None, length=config.max_iterations
    )
    return poses_f, X_f, c0, cost_f


def _block_diag_expand(B, M):
    """(M, 6, 6) -> (6M, 6M) block diagonal."""
    out = jnp.zeros((M, 6, M, 6))
    idx = jnp.arange(M)
    out = out.at[idx, :, idx, :].set(B)
    return out.reshape(6 * M, 6 * M)


@functools.partial(jax.jit, static_argnames=("config",))
def multiview_bundle_adjust(
    observations: jnp.ndarray,   # (M, N, 2) pixel observations per camera
    intrinsics: jnp.ndarray,     # (M, 3, 3)
    init_poses: jnp.ndarray,     # (M, 6) angle-axis+t; row 0 is the gauge
    init_points: jnp.ndarray,    # (N, 3) world (= camera 0) frame
    weights: Optional[jnp.ndarray] = None,   # (M, N) observation weights
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
) -> MultiViewBAResult:
    """Single-device M-camera LM with Schur elimination of the points."""
    M, N = observations.shape[:2]
    w = jnp.ones((M, N)) if weights is None else weights.astype(jnp.float32)

    poses_f, X_f, c0, cost_f = _lm_core(
        init_poses,
        init_points,                       # (N, 3) — all points are local
        jnp.swapaxes(observations, 0, 1),  # (N, M, 2)
        jnp.swapaxes(w, 0, 1),             # (N, M)
        intrinsics,
        config,
        psum_fn=lambda x: x,
    )
    return _pack_result(poses_f, X_f, c0, cost_f)


@functools.lru_cache(maxsize=16)
def _build_dist_multiview_ba(mesh: Mesh, config: BundleAdjustmentConfig,
                             shard_axes: tuple):
    """Cached jitted shard_map multi-view BA (one compile per statics)."""

    def local(obs_blk, w_blk, X0_blk, poses0, Ks):
        def psum_all(x):
            for ax in shard_axes:
                x = lax.psum(x, ax)
            return x

        return _lm_core(
            poses0, X0_blk, obs_blk, w_blk, Ks, config, psum_all
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(shard_axes, None, None),  # obs (N, M, 2) point-sharded
            P(shard_axes, None),        # w (N, M)
            P(shard_axes, None),        # X0 (N, 3)
            P(), P(),
        ),
        out_specs=(P(), P(shard_axes, None), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_multiview_bundle_adjust(
    observations: jnp.ndarray,   # (M, N, 2)
    intrinsics: jnp.ndarray,     # (M, 3, 3)
    init_poses: jnp.ndarray,     # (M, 6)
    init_points: jnp.ndarray,    # (N, 3)
    mesh: Mesh,
    weights: Optional[jnp.ndarray] = None,
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    shard_axes: tuple = ("data", "tile"),
) -> MultiViewBAResult:
    """Points sharded over the mesh; one psum of the 6Mx6M system per LM
    iteration. N must be divisible by the mesh size."""
    M, N = observations.shape[:2]
    w = jnp.ones((M, N)) if weights is None else weights.astype(jnp.float32)

    fn = _build_dist_multiview_ba(mesh, config, tuple(shard_axes))
    poses_f, X_f, c0, cost_f = fn(
        jnp.swapaxes(observations, 0, 1),
        jnp.swapaxes(w, 0, 1),
        init_points,
        init_poses,
        intrinsics,
    )
    return _pack_result(poses_f, X_f, c0, cost_f)


@functools.lru_cache(maxsize=16)
def _build_fuse(mesh: Mesh, shard_axes: tuple):
    def local(p_blk):
        out = p_blk
        for ax in reversed(shard_axes):
            out = lax.all_gather(out, ax, tiled=True)
        return out

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(shard_axes, None),),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def fuse_point_cloud(points_sharded: jnp.ndarray, mesh: Mesh,
                     shard_axes: tuple = ("data", "tile")) -> jnp.ndarray:
    """all_gather the point shards so every device holds the fused cloud."""
    return _build_fuse(mesh, tuple(shard_axes))(points_sharded)


def _pack_result(poses_f, X_f, c0, cost_f) -> MultiViewBAResult:
    def to_mat(pose6):
        R = geo.angle_axis_to_rotation(pose6[:3])
        return jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(pose6[3:])

    return MultiViewBAResult(
        poses=poses_f,
        pose_matrices=jax.vmap(to_mat)(poses_f),
        points=X_f,
        initial_cost=c0,
        final_cost=cost_f,
    )
