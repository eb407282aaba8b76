"""Batched small symmetric-positive-definite solves.

Every Gauss-Newton / Levenberg-Marquardt system in this engine is a damped
normal-equation block (3x3 landmark, 6x6 pose) — symmetric positive
definite by construction.  `jnp.linalg.solve` lowers to LU with partial
pivoting, a poor fit for large batches of tiny matrices.

These routines instead run an UNROLLED Cholesky-Crout factorization and
triangular substitution: for static n (3 or 6) that is a fixed dag of
~n^3/3 fused multiply-adds, each vectorized over the whole batch — no
pivot selection, no data-dependent control flow, pure VPU work that XLA
fuses into a handful of kernels.

Replaces the role of g2o's pre-factored block solvers in the reference
(reference pnpsolver.cpp:19-27, localbundleadjustment.cpp:66-74 use
LinearSolverDense/Eigen on the same damped GN blocks).

Numerics: inputs here are damped (`+ lam*I`), so the sqrt argument is
bounded away from zero; we still clamp at a tiny floor so padded/invalid
rows (identity-damping only) never produce NaN — callers mask those rows
downstream anyway.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-30


def _chol_lower(A):
    """Unrolled lower-Cholesky of [..., n, n] SPD; returns row-lists."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, _EPS))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    return L


def _solve_from_chol(L, b_cols):
    """Solve L L^T x = b for each column vector in b_cols.

    b_cols: list over columns, each a list over the n entries of [...]
    arrays.  Returns same nested structure for x.
    """
    n = len(L)
    out = []
    for col in b_cols:
        # forward: L y = b
        y = [None] * n
        for i in range(n):
            s = col[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        # backward: L^T x = y
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        out.append(x)
    return out


def chol_solve(A, b):
    """x = A^{-1} b for batched SPD A [..., n, n], b [..., n].

    Drop-in for `jnp.linalg.solve(A, b[..., None])[..., 0]` on damped
    normal equations; n is static and small (3 or 6 here).
    """
    L = _chol_lower(A)
    n = A.shape[-1]
    cols = [[b[..., i] for i in range(n)]]
    x = _solve_from_chol(L, cols)[0]
    return jnp.stack(x, axis=-1)


def chol_inv(A):
    """A^{-1} for batched SPD A [..., n, n] (block-Jacobi preconditioners)."""
    L = _chol_lower(A)
    n = A.shape[-1]
    eye_cols = []
    batch_shape = A.shape[:-2]
    one = jnp.ones(batch_shape, A.dtype)
    zero = jnp.zeros(batch_shape, A.dtype)
    for j in range(n):
        eye_cols.append([one if i == j else zero for i in range(n)])
    xcols = _solve_from_chol(L, eye_cols)
    # xcols[j][i] = (A^{-1})[i, j]
    rows = [jnp.stack([xcols[j][i] for j in range(n)], axis=-1)
            for i in range(n)]
    return jnp.stack(rows, axis=-2)
