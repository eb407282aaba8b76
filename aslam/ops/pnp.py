"""2D-3D PnP-RANSAC: pose from landmark reprojections with outlier
rejection.

Replaces `PnPRansac::Compute` (reference Odometry/pnpransac.{h,cpp}:
cv::solvePnPRansac with 500 iterations, 3 px reprojection threshold,
confidence 0.85 — the commented-out alternative to PnPSolver in
TrackLocalMap, tracking.cpp:240).

Batched formulation: instead of minimal P3P solves, each of
`n_hypotheses` parallel hypotheses runs a short Gauss-Newton pose
refinement on a random correspondence subset starting from the prior pose
(always available in a SLAM tracker), then all hypotheses are scored by
their pixel-residual inlier counts and the winner is refined on its
consensus set.  This is the same estimator cv2's iterative-PnP RANSAC
implements, batched.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import CameraModel
from aslam.ops.ba import project_residual_jac
from aslam.ops.linalg import chol_solve
from aslam.utils.se3 import se3_exp


class PnPResult(NamedTuple):
    T_cw: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


def _gn_refine(T0, pts_w, obs_uv, w, cam, iters):
    """Pose-only GN on weighted mono reprojection residuals."""
    dummy_ur = jnp.full(obs_uv.shape[:-1], -1.0)

    def body(_, T):
        r, J, _, depth_ok = project_residual_jac(T, pts_w, obs_uv, dummy_ur, cam)
        r = r[..., :2]
        J = J[..., :2, :]
        wv = w * depth_ok
        H = jnp.einsum("n,nri,nrj->ij", wv, J, J) + 1e-6 * jnp.eye(6)
        b = jnp.einsum("n,nri,nr->i", wv, J, r)
        xi = -chol_solve(H, b)
        xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
        return se3_exp(xi) @ T

    return jax.lax.fori_loop(0, iters, body, T0)


@functools.partial(
    jax.jit, static_argnames=("cam", "n_hypotheses", "sample_size", "iters")
)
def pnp_ransac(
    pts_w: jnp.ndarray,    # [N,3] landmark world positions
    obs_uv: jnp.ndarray,   # [N,2] observed pixels (undistorted)
    valid: jnp.ndarray,    # [N] bool
    T_init: jnp.ndarray,   # [4,4] prior pose
    key: jnp.ndarray,
    cam: CameraModel,
    px_thresh: float = 3.0,      # pnpransac.cpp:36
    min_inliers: int = 10,
    n_hypotheses: int = 64,
    sample_size: int = 8,
    iters: int = 8,
) -> PnPResult:
    N = pts_w.shape[0]
    n_good = jnp.sum(valid.astype(jnp.int32))
    csum = jnp.cumsum(valid.astype(jnp.int32))
    r = jax.random.randint(key, (n_hypotheses, sample_size), 0,
                           jnp.maximum(n_good, 1))
    sample = jnp.clip(jnp.searchsorted(csum, r, side="right"), 0, N - 1)

    def one_hyp(idx):
        w = jnp.zeros((N,)).at[idx].set(1.0) * valid
        return _gn_refine(T_init, pts_w, obs_uv, w, cam, iters)

    Ts = jax.vmap(one_hyp)(sample)                      # [H,4,4]
    Ts = Ts.at[0].set(T_init)                           # prior as rescue

    def score(T):
        r, _, _, depth_ok = project_residual_jac(
            T, pts_w, obs_uv, jnp.full((N,), -1.0), cam)
        err = jnp.linalg.norm(r[..., :2], axis=-1)
        inl = valid & depth_ok & (err < px_thresh)
        return inl, jnp.sum(inl.astype(jnp.int32))

    inls, counts = jax.vmap(score)(Ts)
    best = jnp.argmax(counts)
    # consensus refinement
    T = _gn_refine(Ts[best], pts_w, obs_uv,
                   inls[best].astype(jnp.float32), cam, iters)
    inl, n = score(T)
    ok = n >= min_inliers
    return PnPResult(
        T_cw=jnp.where(ok, T, T_init),
        inliers=inl & ok,
        n_inliers=jnp.where(ok, n, 0),
        ok=ok,
    )
