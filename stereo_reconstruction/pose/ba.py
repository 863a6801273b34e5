"""Two-view bundle adjustment: Levenberg-Marquardt with Schur complement.

Replaces the reference's Ceres solve (``src/PoseEstimation/
bundle_adjustment.h:205-272``: AutoDiff cost, LEVENBERG_MARQUARDT,
DENSE_QR, 20 iterations, 1 thread) with a jittable LM optimizer designed
for batched device execution:

  * variables: 6-DoF pose (angle-axis + translation, exactly the
    reference's ``PoseIncrement`` parameterization) + N 3D points;
  * residuals per point (bundle_adjustment.h:134-161): 2D reprojection
    error in the left camera (projection only — the left camera is the
    identity frame) and in the right camera (transform by pose, then
    project);
  * Jacobian blocks by forward-mode autodiff, vmapped over points (each
    block is 4x6 / 4x3 — tiny dense elementwise math);
  * the normal equations are solved by **Schur complement**: the 3x3 point
    blocks are eliminated analytically, leaving one dense 6x6 camera
    system. Point elimination is an embarrassingly parallel reduction over
    points, so the multi-host version simply ``psum``s the reduced camera
    system (see parallel/ba_dist.py);
  * LM damping with accept/reject steps, fixed trip count (default 20,
    matching Ceres' max_num_iterations), all under ``lax.fori_loop``.

The reference's hard 60-point limit is a Ceres template artifact
(bundle_adjustment.h:12,165) and does not exist here; any static N works,
with optional per-point weights for masked/padded points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from stereo_reconstruction.config import BundleAdjustmentConfig
from stereo_reconstruction.ops import geometry as geo
from stereo_reconstruction.ops import small_linalg


class BAResult(NamedTuple):
    rotation: jnp.ndarray       # (3, 3)
    translation: jnp.ndarray    # (3,)
    pose: jnp.ndarray           # (4, 4)
    points: jnp.ndarray         # (3, N) optimized 3D points (left frame)
    initial_cost: jnp.ndarray   # () mean squared residual at start
    final_cost: jnp.ndarray     # ()
    fundamental: jnp.ndarray    # (3, 3) F from the optimized pose


def _residuals_one(pose6, X, kp_left, kp_right, K_left, K_right):
    """(4,) residuals for one point: [left_x, left_y, right_x, right_y].

    Matches BundleAdjustmentConstraint::operator() semantics
    (bundle_adjustment.h:134-161): residual = observed - projected.
    """
    # left camera: project X directly
    pl = K_left @ X
    pl = pl / pl[2]
    r_left = kp_left[:2] - pl[:2]

    # right camera: rotate+translate then project
    R = geo.angle_axis_to_rotation(pose6[:3])
    Xr = R @ X + pose6[3:]
    pr = K_right @ Xr
    pr = pr / pr[2]
    r_right = kp_right[:2] - pr[:2]
    return jnp.concatenate([r_left, r_right])


@functools.partial(jax.jit, static_argnames=("config",))
def bundle_adjust(
    matches_left: jnp.ndarray,     # (3, N) homogeneous pixels
    matches_right: jnp.ndarray,    # (3, N)
    K_left: jnp.ndarray,
    K_right: jnp.ndarray,
    init_rotation: jnp.ndarray,    # (3, 3)
    init_translation: jnp.ndarray,  # (3,)
    init_points: jnp.ndarray,      # (3, N) initial 3D points (left frame)
    weights: Optional[jnp.ndarray] = None,   # (N,) 0/1 mask for padded pts
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
) -> BAResult:
    n = matches_left.shape[-1]
    w = jnp.ones((n,)) if weights is None else weights.astype(jnp.float32)

    kp_l = matches_left.T        # (N, 3)
    kp_r = matches_right.T
    X0 = init_points.T           # (N, 3)
    pose0 = jnp.concatenate(
        [geo.rotation_to_angle_axis(init_rotation), init_translation]
    )

    res_fn = functools.partial(_residuals_one, K_left=K_left, K_right=K_right)

    def residuals_all(pose6, X):
        return jax.vmap(lambda x, kl, kr: res_fn(pose6, x, kl, kr))(X, kp_l, kp_r)

    def cost(pose6, X):
        r = residuals_all(pose6, X)              # (N, 4)
        return jnp.sum((r * r) * w[:, None])

    # per-point Jacobians via forward-mode autodiff
    jac_pose = jax.vmap(
        lambda x, kl, kr, p: jax.jacfwd(lambda q: res_fn(q, x, kl, kr))(p),
        in_axes=(0, 0, 0, None),
    )
    jac_point = jax.vmap(
        lambda x, kl, kr, p: jax.jacfwd(lambda xx: res_fn(p, xx, kl, kr))(x),
        in_axes=(0, 0, 0, None),
    )

    def robust_weights(pose6, X):
        """IRLS weights: 1 for L2; Huber clip beyond delta px per point."""
        if config.loss != "huber":
            return w
        r = residuals_all(pose6, X)                           # (N, 4)
        err = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)       # (N,) px
        hub = jnp.minimum(1.0, config.huber_delta / err)
        return w * jnp.sqrt(hub)

    def lm_step(state, _):
        pose6, X, lam, current_cost = state

        rw = robust_weights(pose6, X)
        r = residuals_all(pose6, X) * rw[:, None]             # (N, 4)
        Jp = jac_pose(X, kp_l, kp_r, pose6) * rw[:, None, None]   # (N, 4, 6)
        Jx = jac_point(X, kp_l, kp_r, pose6) * rw[:, None, None]  # (N, 4, 3)

        # normal-equation blocks (gradient of 1/2||r||^2 uses J^T r; note
        # residual = obs - pred so the GN step solves J^T J d = -J^T r)
        B = jnp.einsum("nri,nrj->ij", Jp, Jp)                # (6, 6)
        E = jnp.einsum("nri,nrj->nij", Jp, Jx)               # (N, 6, 3)
        C = jnp.einsum("nri,nrj->nij", Jx, Jx)               # (N, 3, 3)
        v = -jnp.einsum("nri,nr->i", Jp, r)                  # (6,)
        g = -jnp.einsum("nri,nr->ni", Jx, r)                 # (N, 3)

        lamI3 = lam * jnp.eye(3)
        C_damped = C + lamI3[None]
        # closed-form 3x3 inverses + unrolled 6x6 SPD solve
        # (ops/small_linalg.py): the LU-shaped linalg custom calls were
        # the latency chain of the 20-step LM scan
        C_inv = small_linalg.inv3(C_damped)                  # (N, 3, 3)

        # Schur complement onto the camera block
        EC = E @ C_inv                                        # (N, 6, 3)
        S = B + lam * jnp.eye(6) - jnp.einsum("nij,nkj->ik", EC, E)
        rhs = v - jnp.einsum("nij,nj->i", EC, g)
        d_pose = small_linalg.solve_spd_small(S, rhs)

        # back-substitute point updates
        d_X = jnp.einsum("nij,nj->ni", C_inv, g - jnp.einsum("nji,j->ni", E, d_pose))

        new_pose = pose6 + d_pose
        new_X = X + d_X
        new_cost = cost(new_pose, new_X)

        accept = new_cost < current_cost
        pose6 = jnp.where(accept, new_pose, pose6)
        X = jnp.where(accept, new_X, X)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * config.lambda_down, config.min_lambda),
            jnp.minimum(lam * config.lambda_up, config.max_lambda),
        )
        current_cost = jnp.where(accept, new_cost, current_cost)
        return (pose6, X, lam, current_cost), None

    c0 = cost(pose0, X0)
    init = (pose0, X0, jnp.asarray(config.init_lambda, jnp.float32), c0)
    (pose_f, X_f, _, cost_f), _ = lax.scan(
        lm_step, init, None, length=config.max_iterations
    )

    R = geo.angle_axis_to_rotation(pose_f[:3])
    T = pose_f[3:]
    pose_mat = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(T)
    E_mat = geo.essential_from_pose(R, T)
    F = geo.fundamental_from_essential(E_mat, K_left, K_right)

    return BAResult(
        rotation=R,
        translation=T,
        pose=pose_mat,
        points=X_f.T,
        initial_cost=c0,
        final_cost=cost_f,
        fundamental=F,
    )
