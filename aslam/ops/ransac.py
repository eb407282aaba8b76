"""Parallel-hypothesis Mahalanobis 3D-3D RANSAC.

Replaces `Ransac::Iterate` (reference ransac.cpp:155-267).  The reference
runs up to 200 *sequential* hypotheses, each with up to 20 inner refinement
steps and early exit at 50/75/80% inlier fractions (ransac.cpp:87-136).
Here all hypotheses are evaluated *simultaneously*: one batched sample ->
weighted-Kabsch fit -> iterate (Mahalanobis gate -> masked refit) a fixed
number of times -> argmax selection.  The identity transform is scored as
hypothesis 0, subsuming the reference's identity-rescue fallback
(ransac.cpp:252-264).

Error model (ransac.cpp:350-431, RGBDSLAM-v2 style):
  per-point covariance  diag(raster_cov_x * z, raster_cov_y * z, (c z^2)^2)
  with raster_stddev = 3 tan(fov / resolution) and Khoshelham depth noise
  sigma_z = c z^2 (c = 0.01).  The source covariance is rotated into the
  target frame and the gate is the squared Mahalanobis distance under the
  summed covariance.  (The reference rotates with R^T Sigma R
  (ransac.cpp:409) — we use the correct congruence R Sigma R^T; the gate
  differs only for strongly anisotropic off-axis points.)

Fit weights are 1/(z1*z2) exactly as `GetTransformFromMatches`
(ransac.cpp:295-313).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import CameraModel, RansacConfig
from aslam.ops.linalg import chol_solve
from aslam.utils.se3 import weighted_kabsch


class RansacResult(NamedTuple):
    T12: jnp.ndarray          # [4,4] source-cam -> target-cam transform
    inliers: jnp.ndarray      # [M] bool inlier mask over the match pool
    n_inliers: jnp.ndarray    # scalar int32
    rmse: jnp.ndarray         # scalar float32: sqrt(mean sq. mahalanobis)
    ok: jnp.ndarray           # scalar bool: n_inliers >= min_inliers


def _point_cov_diag(p: jnp.ndarray, cam: CameraModel, depth_std_c: float):
    """Per-point diagonal covariance entries [..., 3]."""
    rx = 3.0 * math.tan(math.radians(cam.fov_x_deg) / cam.width)
    ry = 3.0 * math.tan(math.radians(cam.fov_y_deg) / cam.height)
    z = p[..., 2]
    sz = depth_std_c * z * z
    return jnp.stack([rx * rx * z, ry * ry * z, sz * sz], axis=-1)


def mahalanobis_sq(
    p1: jnp.ndarray,          # [..., M, 3] source points (cam 1)
    p2: jnp.ndarray,          # [..., M, 3] target points (cam 2)
    T12: jnp.ndarray,         # [..., 4, 4]
    cam: CameraModel,
    depth_std_c: float,
) -> jnp.ndarray:
    """Squared Mahalanobis distance of T12*p1 vs p2 under the summed
    anisotropic covariances (ErrorFunction2, ransac.cpp:350-431)."""
    R = T12[..., :3, :3]
    t = T12[..., :3, 3]
    p1_in2 = jnp.einsum("...ij,...mj->...mi", R, p1) + t[..., None, :]
    delta = p1_in2 - p2

    c1 = _point_cov_diag(p1, cam, depth_std_c)       # [...,M,3]
    c2 = _point_cov_diag(p2, cam, depth_std_c)
    # rotate source covariance into frame 2: R diag(c1) R^T
    Rc = R[..., None, :, :]                          # [...,1,3,3]
    cov1_rot = (Rc * c1[..., None, :]) @ jnp.swapaxes(Rc, -1, -2)
    sigma = cov1_rot.at[..., 0, 0].add(c2[..., 0])
    sigma = sigma.at[..., 1, 1].add(c2[..., 1])
    sigma = sigma.at[..., 2, 2].add(c2[..., 2])
    # tiny jitter for far-invalid points, keeps the solve well-posed
    sigma = sigma + jnp.eye(3) * 1e-12
    sol = chol_solve(sigma, delta)
    return jnp.sum(delta * sol, axis=-1)


def _score(n_inl: jnp.ndarray, rmse: jnp.ndarray) -> jnp.ndarray:
    """Hypothesis ranking: inlier count first, then low rmse
    (the reference accepts on `count >= best && error <= best`,
    ransac.cpp:123-124)."""
    return n_inl.astype(jnp.float32) * 16.0 - jnp.minimum(rmse, 15.9)


@functools.partial(jax.jit, static_argnames=("cfg", "cam"))
def ransac_align(
    p1: jnp.ndarray,          # [M,3] matched source points (cam-1 frame)
    p2: jnp.ndarray,          # [M,3] matched target points (cam-2 frame)
    valid: jnp.ndarray,       # [M] bool (padding / depth validity)
    key: jnp.ndarray,         # PRNG key
    cfg: RansacConfig,
    cam: CameraModel,
) -> RansacResult:
    """Estimate T12 with p2 ~= T12 * p1 over the padded match pool."""
    M = p1.shape[0]
    max_m2 = cfg.max_mahalanobis * cfg.max_mahalanobis

    # depth-validity filter (ransac.cpp:61-75)
    good = valid & (p1[:, 2] > 0) & (p2[:, 2] > 0) \
        & jnp.isfinite(p1[:, 2]) & jnp.isfinite(p2[:, 2])
    n_good = jnp.sum(good.astype(jnp.int32))
    w_base = jnp.where(good, 1.0 / jnp.maximum(p1[:, 2] * p2[:, 2], 1e-6), 0.0)

    # --- sample: uniform over the good subset via inverse-CDF ---
    H, S = cfg.n_hypotheses, cfg.sample_size
    csum = jnp.cumsum(good.astype(jnp.int32))
    r = jax.random.randint(key, (H, S), 0, jnp.maximum(n_good, 1))
    sample_idx = jnp.searchsorted(csum, r, side="right")
    sample_idx = jnp.clip(sample_idx, 0, M - 1)

    s1 = p1[sample_idx]                      # [H,S,3]
    s2 = p2[sample_idx]
    sw = w_base[sample_idx]
    T0 = weighted_kabsch(s1, s2, sw)         # [H,4,4]
    # hypothesis 0 = identity (rescue fallback, ransac.cpp:252-264)
    T0 = T0.at[0].set(jnp.eye(4))

    p1b = jnp.broadcast_to(p1, (H, M, 3))
    p2b = jnp.broadcast_to(p2, (H, M, 3))

    def eval_T(T):
        m2 = mahalanobis_sq(p1b, p2b, T, cam, cfg.depth_std_c)   # [H,M]
        inl = good[None, :] & (m2 <= max_m2) & (m2 >= 0.0)
        n = jnp.sum(inl, axis=1)
        mean = jnp.sum(jnp.where(inl, m2, 0.0), axis=1) / jnp.maximum(n, 1)
        rmse = jnp.where(n >= 3, jnp.sqrt(mean), 1e3)
        return inl, n.astype(jnp.int32), rmse

    def refine_step(carry, _):
        T, _, _, _ = carry
        inl, n, rmse = eval_T(T)
        w = w_base[None, :] * inl
        T_new = weighted_kabsch(p1b, p2b, w)
        # keep previous T when the fit is degenerate
        degenerate = (n < 3)[:, None, None]
        T_new = jnp.where(degenerate, T, T_new)
        T_new = T_new.at[0].set(jnp.eye(4))  # identity hypothesis stays fixed
        return (T_new, inl, n, rmse), None

    init_inl = jnp.zeros((H, M), jnp.bool_)
    init = (T0, init_inl, jnp.zeros((H,), jnp.int32), jnp.full((H,), 1e3))
    (T, _, _, _), _ = jax.lax.scan(refine_step, init, None, length=cfg.refine_iters)
    # final consistent evaluation of the refined transforms
    inl, n, rmse = eval_T(T)

    best = jnp.argmax(_score(n, rmse))
    T_best = T[best]
    inl_best = inl[best]
    n_best = n[best]
    rmse_best = rmse[best]
    ok = n_best >= cfg.min_inliers
    T_best = jnp.where(ok, T_best, jnp.eye(4))
    return RansacResult(
        T12=T_best,
        inliers=inl_best & ok,
        n_inliers=jnp.where(ok, n_best, 0),
        rmse=rmse_best,
        ok=ok,
    )
