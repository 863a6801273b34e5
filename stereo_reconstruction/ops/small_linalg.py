"""Batched small-matrix eigensolvers that vmap and compile well.

The pose stage's hot loop (RANSAC over K hypotheses x 4 cheirality
candidates, pose/ransac.py + pose/eight_point.py) needs three factor
operations per hypothesis:

  * the smallest eigenvector of a 9x9 Gram matrix chi^T chi (the
    essential-vector solve; the reference uses a (12, 9) JacobiSVD,
    eight_point.cpp:34-38),
  * an SVD of the resulting 3x3 essential estimate
    (eight_point.cpp:40-51),
  * the smallest eigenvector of an ARROW matrix diag(d) + rank-pattern
    border (the joint-depth triangulation, eight_point.cpp:120-147).

``jnp.linalg.svd``/``eigh`` lower to QDWH-type iterations whose cost at
9x9 is all fixed overhead, and a batched pose stage spent most of its
time there. These replacements are pure elementwise/matmul code — no
LAPACK-shaped custom calls — so they batch at full vector width:

  * ``jacobi_eigh``: fixed-sweep cyclic Jacobi for symmetric n<=~12
    matrices (statically unrolled rotations, batch-broadcast),
  * ``svd3_for_essential``: 3x3 SVD built from a 3x3 Jacobi eigh of
    E^T E with det(U) = det(V) = +1 by construction (the form the
    essential-matrix candidate step needs; the SVD column-sign freedom
    maps candidates onto each other, so the candidate SET is identical),
  * ``arrow_smallest_eigvec``: the smallest eigenpair of an arrow
    matrix [[diag(d), c], [c^T, g]] via its secular equation
    f(lam) = (g - lam) - sum_i c_i^2/(d_i - lam), bisected then
    Newton-polished on [0, min d) — O(N) per iteration instead of an
    O(N^3) dense eigendecomposition (the N=500 pose-filter stage built
    a 501x501 dense matrix for ONE eigenvector).

Accuracy: f32 to ~1e-6 relative on well-conditioned inputs
(tests/test_small_linalg.py pins against numpy in f64); degenerate
inputs (zero columns, repeated eigenvalues) return finite garbage that
downstream validity flags already reject, exactly as the dense paths
did.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(A: jnp.ndarray, sweeps: int = 6):
    """Eigendecomposition of symmetric (..., n, n) via cyclic Jacobi.

    Returns (eigenvalues ascending, eigenvectors as columns) like
    ``jnp.linalg.eigh``. Intended for n <= ~12 (rotations are unrolled:
    sweeps * n*(n-1)/2 of them, each two (n, n) matmuls over the batch).
    """
    n = A.shape[-1]
    A = 0.5 * (A + A.mT)                       # enforce exact symmetry
    V = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape) + 0.0 * A

    # the sweeps run under lax.fori_loop so the rotation graph compiles
    # ONCE, not `sweeps` times (a smaller graph and a shorter compile)
    def one_sweep(_, AV):
        A, V = AV
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = A[..., p, p]
                aqq = A[..., q, q]
                apq = A[..., p, q]
                # rotation angle zeroing (p, q); guard apq ~ 0
                small = jnp.abs(apq) <= 1e-37
                tau = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
                t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
                t = jnp.where(jnp.sign(tau) == 0.0,
                              1.0 / (tau + jnp.sqrt(1.0 + tau * tau)), t)
                c = 1.0 / jnp.sqrt(1.0 + t * t)
                s = t * c
                c = jnp.where(small, 1.0, c)[..., None]
                s = jnp.where(small, 0.0, s)[..., None]
                # A <- J^T A J with J = I except J[pp]=J[qq]=c,
                # J[pq]=s, J[qp]=-s; only rows/cols p, q change
                Ap, Aq = A[..., p, :], A[..., q, :]
                A = A.at[..., p, :].set(c * Ap - s * Aq)
                A = A.at[..., q, :].set(s * Ap + c * Aq)
                Ap, Aq = A[..., :, p], A[..., :, q]
                A = A.at[..., :, p].set(c * Ap - s * Aq)
                A = A.at[..., :, q].set(s * Ap + c * Aq)
                Vp, Vq = V[..., :, p], V[..., :, q]
                V = V.at[..., :, p].set(c * Vp - s * Vq)
                V = V.at[..., :, q].set(s * Vp + c * Vq)
        return A, V

    A, V = lax.fori_loop(0, sweeps, one_sweep, (A, V))

    w = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V


def smallest_eigvec(A: jnp.ndarray, sweeps: int = 6) -> jnp.ndarray:
    """Unit eigenvector (..., n) for the smallest eigenvalue of a
    symmetric batch — the chi^T chi null-vector solve."""
    _, V = jacobi_eigh(A, sweeps=sweeps)
    return V[..., :, 0]


def svd3_for_essential(E: jnp.ndarray, sweeps: int = 8):
    """(U, Vt) of a 3x3 batch with det(U) = det(Vt) = +1.

    Built from a Jacobi eigh of E^T E: V's columns are singular vectors
    (descending), U columns are normalized E @ v_i completed by a cross
    product, so both determinants are +1 by construction — the state the
    essential-candidate step needs after its sign fix
    (eight_point.cpp:40-51). The sigma_3 ~ 0 column of U never comes
    from division by the tiny sigma_3.
    """
    G = E.mT @ E
    w, V = jacobi_eigh(G, sweeps=sweeps)
    # descending singular order
    V = V[..., :, ::-1]
    v1 = V[..., :, 0]
    v2 = V[..., :, 1]

    def unit(x):
        return x / jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True) + 1e-30)

    u1 = unit((E @ v1[..., None])[..., 0])
    u2raw = (E @ v2[..., None])[..., 0]
    u2 = unit(u2raw - jnp.sum(u2raw * u1, axis=-1, keepdims=True) * u1)
    u3 = jnp.cross(u1, u2)
    U = jnp.stack([u1, u2, u3], axis=-1)
    # det(U) = +1 by the cross-product completion; fix det(V) = +1
    detV = jnp.linalg.det(V)
    V = V.at[..., :, 2].multiply(jnp.sign(detV)[..., None])
    return U, V.mT


def inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of a (..., 3, 3) batch — pure
    elementwise ops, replacing the LU-shaped ``jnp.linalg.inv`` in the
    BA Schur step's per-point block inversions (pose/ba.py)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    adj = jnp.stack([
        jnp.stack([c11, c12, c13], axis=-1),
        jnp.stack([c21, c22, c23], axis=-1),
        jnp.stack([c31, c32, c33], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


def solve_spd_small(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for a small (..., n, n) symmetric positive-definite
    batch via a statically unrolled Cholesky + two triangular
    substitutions — replaces the pivoted-LU ``jnp.linalg.solve`` on the
    6x6 Schur system of the BA step. n is static and small (<= ~8)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        for i2 in range(j + 1, n):
            s = A[..., i2, j]
            for k in range(j):
                s = s - L[i2][k] * L[j][k]
            L[i2][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i2 in range(n):
        s = b[..., i2]
        for k in range(i2):
            s = s - L[i2][k] * y[k]
        y[i2] = s / L[i2][i2]
    # back substitution L^T x = y
    x = [None] * n
    for i2 in reversed(range(n)):
        s = y[i2]
        for k in range(i2 + 1, n):
            s = s - L[k][i2] * x[k]
        x[i2] = s / L[i2][i2]
    return jnp.stack(x, axis=-1)


@functools.partial(jax.jit, static_argnames=("bisect_iters", "newton_iters"))
def arrow_smallest_eigvec(
    diag: jnp.ndarray,      # (..., N) positive diagonal d
    cross: jnp.ndarray,     # (..., N) border column c
    corner: jnp.ndarray,    # (...,)   corner g
    bisect_iters: int = 30,
    newton_iters: int = 3,
):
    """Smallest eigenpair of the PSD arrow matrix [[diag(d), c],[c^T, g]],
    returned as (lambda, ratio) with ratio_i = v_i / v_N = -c_i/(d_i - lambda)
    — exactly the depth vector the triangulation consumes, without ever
    materializing the (N+1)x(N+1) matrix.

    The smallest eigenvalue is the unique root of the secular function
    f(lam) = (g - lam) - sum_i c_i^2/(d_i - lam) on [0, min_i d_i): f is
    strictly decreasing there, f(0) = the (scalar) Schur complement >= 0
    for a PSD matrix, and f -> -inf at the first pole. Bisection brackets
    the root; clamped Newton polishes it.
    """
    d_min = jnp.min(diag, axis=-1)
    eps = 1e-7 * jnp.maximum(d_min, 1e-30)

    def f(lam):
        denom = diag - lam[..., None]
        denom = jnp.where(jnp.abs(denom) < 1e-30,
                          jnp.where(denom < 0, -1e-30, 1e-30), denom)
        return (corner - lam) - jnp.sum(cross * cross / denom, axis=-1)

    lo = jnp.zeros_like(d_min)
    hi = jnp.maximum(d_min - eps, 0.0)

    def bisect(_, lohix):
        lo, hi = lohix
        mid = 0.5 * (lo + hi)
        go_right = f(mid) > 0
        return jnp.where(go_right, mid, lo), jnp.where(go_right, hi, mid)

    lo, hi = lax.fori_loop(0, bisect_iters, bisect, (lo, hi))
    lam = 0.5 * (lo + hi)
    for _ in range(newton_iters):
        denom = diag - lam[..., None]
        denom = jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        fp = -1.0 - jnp.sum(cross * cross / (denom * denom), axis=-1)
        lam = jnp.clip(lam - f(lam) / fp, lo, hi)

    denom = diag - lam[..., None]
    denom = jnp.where(jnp.abs(denom) < 1e-30,
                      jnp.where(denom < 0, -1e-30, 1e-30), denom)
    ratio = -cross / denom
    return lam, ratio
