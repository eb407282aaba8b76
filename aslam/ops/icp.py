"""ICP refinement: projective data association + point-to-plane
Gauss-Newton with per-correspondence robust weights.

Replaces both the PCL GICP wrapper (reference
Odometry/generalizedicp.{h,cpp}: plane-to-plane GICP, 10-15 iters,
max_corr_dist 0.05-0.07, adaptive correspondence distance clamped
[0.01, 0.08], generalizedicp.cpp:91-134) and the vendored libicp
(Odometry/icp/: kd-tree point-to-plane, commented out of the build).

Batched redesign (SURVEY.md §7.3 item 4: kd-trees don't batch):
correspondences come from *projective association* — transform source
points, project into the target depth image, gather the target point +
normal at that pixel.  This is O(N) gathers instead of O(N log N) tree
walks, fully batched, and the standard choice for frame-to-frame RGB-D
ICP (KinectFusion-style).  Normals come from a dense cross-product over
the backprojected depth image (replacing PCL normal estimation,
utils.cpp:168-182).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import CameraModel, ICPConfig
from aslam.ops.linalg import chol_solve
from aslam.utils.se3 import se3_exp


class ICPResult(NamedTuple):
    T12: jnp.ndarray        # refined source-cam -> target-cam transform
    rmse: jnp.ndarray       # scalar: sqrt(mean point-to-plane residual^2)
    n_corr: jnp.ndarray     # scalar int32 correspondences in final iter
    converged: jnp.ndarray  # scalar bool


def backproject_depth(depth: jnp.ndarray, cam: CameraModel) -> jnp.ndarray:
    """Depth image [H,W] -> camera-frame point image [H,W,3] (0 where
    invalid)."""
    H, W = depth.shape
    v = jnp.arange(H, dtype=jnp.float32)[:, None]
    u = jnp.arange(W, dtype=jnp.float32)[None, :]
    x = (u - cam.cx) / cam.fx * depth
    y = (v - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def normal_map(points: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel normals from central differences of the point image:
    n = normalize(dP/du x dP/dv), oriented toward the camera.  Zero where
    neighbors are invalid (depth holes)."""
    du = jnp.roll(points, -1, axis=1) - jnp.roll(points, 1, axis=1)
    dv = jnp.roll(points, -1, axis=0) - jnp.roll(points, 1, axis=0)
    n = jnp.cross(du, dv)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-9)
    # orient toward camera (points have +z away): n.z should be negative
    flip = jnp.sum(n * points, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    ok = (
        valid
        & jnp.roll(valid, -1, axis=1) & jnp.roll(valid, 1, axis=1)
        & jnp.roll(valid, -1, axis=0) & jnp.roll(valid, 1, axis=0)
        & (norm[..., 0] > 1e-9)
    )
    return jnp.where(ok[..., None], n, 0.0)


@functools.partial(jax.jit, static_argnames=("cam", "cfg"))
def icp_refine(
    src_pts: jnp.ndarray,     # [N,3] source camera-frame points
    src_valid: jnp.ndarray,   # [N] bool
    target_depth: jnp.ndarray,  # [H,W] target frame depth (m)
    T12_init: jnp.ndarray,    # [4,4] initial source->target transform
    cam: CameraModel,
    cfg: ICPConfig,
) -> ICPResult:
    """Point-to-plane ICP of a source point set onto a target depth map."""
    H, W = target_depth.shape
    tgt_valid = target_depth > 0.05
    tgt_pts = backproject_depth(target_depth, cam)
    tgt_n = normal_map(tgt_pts, tgt_valid)

    def corr_terms(T, max_d):
        p = src_pts @ T[:3, :3].T + T[:3, 3]          # [N,3] in target cam
        z = p[:, 2]
        u = jnp.clip(jnp.round(cam.fx * p[:, 0] / jnp.maximum(z, 1e-6) + cam.cx
                               ).astype(jnp.int32), 0, W - 1)
        v = jnp.clip(jnp.round(cam.fy * p[:, 1] / jnp.maximum(z, 1e-6) + cam.cy
                               ).astype(jnp.int32), 0, H - 1)
        q = tgt_pts[v, u]
        n = tgt_n[v, u]
        has_n = jnp.sum(n * n, axis=-1) > 0.5
        d = p - q
        dist = jnp.linalg.norm(d, axis=-1)
        r = jnp.sum(n * d, axis=-1)                   # point-to-plane
        ok = (
            src_valid & (z > 0.05) & tgt_valid[v, u] & has_n
            & (dist < max_d)
        )
        return p, n, r, ok

    def body(carry, _):
        T, max_d = carry
        p, n, r, ok = corr_terms(T, max_d)
        w = ok.astype(jnp.float32)
        # J = [n, p x n] for left-multiplicative twist [rho, phi]
        J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)    # [N,6]
        Hm = jnp.einsum("n,ni,nj->ij", w, J, J) + 1e-6 * jnp.eye(6)
        b = jnp.einsum("n,ni,n->i", w, J, r)
        xi = -chol_solve(Hm, b)
        xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
        T_new = se3_exp(xi) @ T
        # adaptive correspondence distance from the residual scale
        # (generalizedicp.cpp:91-134: clamp to [0.01, 0.08])
        n_ok = jnp.maximum(jnp.sum(w), 1.0)
        mean_abs = jnp.sum(jnp.abs(r) * w) / n_ok
        new_max = jnp.clip(3.0 * mean_abs, 0.01, 0.08)
        return (T_new, new_max), None

    init = (T12_init, jnp.asarray(cfg.max_corr_dist, jnp.float32))
    (T, max_d), _ = jax.lax.scan(body, init, None, length=cfg.iterations)

    _, _, r, ok = corr_terms(T, max_d)
    n_corr = jnp.sum(ok.astype(jnp.int32))
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(ok, r * r, 0.0)) / jnp.maximum(n_corr, 1)
    )
    converged = (n_corr >= 10) & jnp.all(jnp.isfinite(T))
    T = jnp.where(converged, T, T12_init)
    return ICPResult(T12=T, rmse=rmse, n_corr=n_corr, converged=converged)


# ------------------------------------------------------------------ GICP

def _plane_cov(n: jnp.ndarray, has_n: jnp.ndarray, eps: float) -> jnp.ndarray:
    """Per-point plane-to-plane covariance C = R diag(eps,1,1) R^T =
    I - (1-eps) n n^T for unit normal n (Segal's GICP surface model, the
    distribution pcl::GeneralizedIterativeClosestPoint builds per point —
    reference Odometry/generalizedicp.h:41).  Isotropic I where no normal
    exists (degrades to point-to-point)."""
    nnT = n[..., :, None] * n[..., None, :]
    C = jnp.eye(3) - (1.0 - eps) * nnT
    return jnp.where(has_n[..., None, None], C, jnp.eye(3))


@functools.partial(jax.jit, static_argnames=("cam", "cfg"))
def gicp_refine(
    src_pts: jnp.ndarray,      # [N,3] source camera-frame points
    src_normals: jnp.ndarray,  # [N,3] source normals (0 where unknown)
    src_valid: jnp.ndarray,    # [N] bool
    target_depth: jnp.ndarray,  # [H,W] target frame depth (m)
    T12_init: jnp.ndarray,     # [4,4] initial source->target transform
    cam: CameraModel,
    cfg: ICPConfig,
) -> ICPResult:
    """Plane-to-plane (generalized) ICP onto a target depth map: per-point
    covariances C = R diag(eps,1,1) R^T on BOTH clouds, Gauss-Newton on the
    Mahalanobis 3D residual d^T (C_q + R C_p R^T)^-1 d (replaces
    pcl::GeneralizedIterativeClosestPoint, generalizedicp.cpp:65-89).
    Association stays projective (batched, no kd-tree)."""
    H, W = target_depth.shape
    eps = cfg.gicp_epsilon
    tgt_valid = target_depth > 0.05
    tgt_pts = backproject_depth(target_depth, cam)
    tgt_n = normal_map(tgt_pts, tgt_valid)
    src_has_n = jnp.sum(src_normals * src_normals, axis=-1) > 0.5

    def corr_terms(T, max_d):
        R = T[:3, :3]
        p = src_pts @ R.T + T[:3, 3]                  # [N,3] in target cam
        np_rot = src_normals @ R.T                    # rotated src normals
        z = p[:, 2]
        u = jnp.clip(jnp.round(cam.fx * p[:, 0] / jnp.maximum(z, 1e-6) + cam.cx
                               ).astype(jnp.int32), 0, W - 1)
        v = jnp.clip(jnp.round(cam.fy * p[:, 1] / jnp.maximum(z, 1e-6) + cam.cy
                               ).astype(jnp.int32), 0, H - 1)
        q = tgt_pts[v, u]
        nq = tgt_n[v, u]
        has_nq = jnp.sum(nq * nq, axis=-1) > 0.5
        d = p - q
        dist = jnp.linalg.norm(d, axis=-1)
        ok = src_valid & (z > 0.05) & tgt_valid[v, u] & has_nq & (dist < max_d)
        # combined covariance M = C_q + R C_p R^T; weight W = M^-1
        M = _plane_cov(nq, has_nq, eps) + _plane_cov(np_rot, src_has_n, eps)
        Wi = jnp.linalg.inv(M + 1e-6 * jnp.eye(3))
        return p, d, Wi, ok, dist

    def body(carry, _):
        T, max_d = carry
        p, d, Wi, ok, dist = corr_terms(T, max_d)
        w = ok.astype(jnp.float32)
        # J [N,3,6] = [I3, -skew(p')] for left twist [rho, phi]
        N = p.shape[0]
        J = jnp.zeros((N, 3, 6))
        J = J.at[:, :, :3].set(jnp.eye(3))
        J = J.at[:, 0, 4].set(p[:, 2]).at[:, 0, 5].set(-p[:, 1])
        J = J.at[:, 1, 3].set(-p[:, 2]).at[:, 1, 5].set(p[:, 0])
        J = J.at[:, 2, 3].set(p[:, 1]).at[:, 2, 4].set(-p[:, 0])
        WJ = jnp.einsum("nij,njk->nik", Wi, J)
        Hm = jnp.einsum("n,nri,nrj->ij", w, J, WJ) + 1e-6 * jnp.eye(6)
        b = jnp.einsum("n,nri,nr->i", w, WJ, d)
        xi = -chol_solve(Hm, b)
        xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
        T_new = se3_exp(xi) @ T
        n_ok = jnp.maximum(jnp.sum(w), 1.0)
        mean_d = jnp.sum(dist * w) / n_ok
        new_max = jnp.clip(3.0 * mean_d, 0.01, 0.08)
        return (T_new, new_max), None

    init = (T12_init, jnp.asarray(cfg.max_corr_dist, jnp.float32))
    (T, max_d), _ = jax.lax.scan(body, init, None, length=cfg.iterations)

    p, d, Wi, ok, dist = corr_terms(T, max_d)
    n_corr = jnp.sum(ok.astype(jnp.int32))
    md = jnp.einsum("ni,nij,nj->n", d, Wi, d)
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(ok, jnp.sum(d * d, -1), 0.0))
        / jnp.maximum(n_corr, 1)
    )
    converged = (n_corr >= 10) & jnp.all(jnp.isfinite(T))
    T = jnp.where(converged, T, T12_init)
    return ICPResult(T12=T, rmse=rmse, n_corr=n_corr, converged=converged)


@functools.partial(jax.jit, static_argnames=("cfg", "iters"))
def gicp_align_matched(
    p1: jnp.ndarray,       # [N,3] source points (cam 1)
    n1: jnp.ndarray,       # [N,3] source normals (0 = unknown)
    p2: jnp.ndarray,       # [N,3] matched target points (cam 2)
    n2: jnp.ndarray,       # [N,3] target normals
    pair_valid: jnp.ndarray,  # [N] bool
    T12_init: jnp.ndarray,
    cfg: ICPConfig,
    iters: int = 10,
) -> ICPResult:
    """GICP over FIXED correspondences (the reference's matched-keypoint-
    cloud variant, generalizedicp.cpp:24-53: source/target clouds built
    from RANSAC-inlier matches, then GICP refinement)."""
    eps = cfg.gicp_epsilon
    has1 = jnp.sum(n1 * n1, axis=-1) > 0.5
    has2 = jnp.sum(n2 * n2, axis=-1) > 0.5
    C2 = _plane_cov(n2, has2, eps)

    def body(T, _):
        R = T[:3, :3]
        p = p1 @ R.T + T[:3, 3]
        C1r = _plane_cov(n1 @ R.T, has1, eps)
        Wi = jnp.linalg.inv(C2 + C1r + 1e-6 * jnp.eye(3))
        d = p - p2
        w = pair_valid.astype(jnp.float32)
        N = p.shape[0]
        J = jnp.zeros((N, 3, 6))
        J = J.at[:, :, :3].set(jnp.eye(3))
        J = J.at[:, 0, 4].set(p[:, 2]).at[:, 0, 5].set(-p[:, 1])
        J = J.at[:, 1, 3].set(-p[:, 2]).at[:, 1, 5].set(p[:, 0])
        J = J.at[:, 2, 3].set(p[:, 1]).at[:, 2, 4].set(-p[:, 0])
        WJ = jnp.einsum("nij,njk->nik", Wi, J)
        Hm = jnp.einsum("n,nri,nrj->ij", w, J, WJ) + 1e-6 * jnp.eye(6)
        b = jnp.einsum("n,nri,nr->i", w, WJ, d)
        xi = -chol_solve(Hm, b)
        xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
        return se3_exp(xi) @ T, None

    T, _ = jax.lax.scan(body, T12_init, None, length=iters)
    R = T[:3, :3]
    d = (p1 @ R.T + T[:3, 3]) - p2
    n_corr = jnp.sum(pair_valid.astype(jnp.int32))
    rmse = jnp.sqrt(
        jnp.sum(jnp.where(pair_valid, jnp.sum(d * d, -1), 0.0))
        / jnp.maximum(n_corr, 1)
    )
    converged = (n_corr >= 10) & jnp.all(jnp.isfinite(T))
    T = jnp.where(converged, T, T12_init)
    return ICPResult(T12=T, rmse=rmse, n_corr=n_corr, converged=converged)


def subset_mask(key: jnp.ndarray, valid: jnp.ndarray,
                frac: float = 0.75) -> jnp.ndarray:
    """Random point subset (the reference's ComputeSubset 75% variant,
    generalizedicp.cpp:136-160): keep ~frac of the valid points."""
    return valid & (jax.random.uniform(key, valid.shape) < frac)


@functools.partial(jax.jit, static_argnames=("cell",))
def voxel_downsample(pts: jnp.ndarray, valid: jnp.ndarray, cell: float = 0.03,
                     max_out: int | None = None):
    """Voxel-grid thinning (replaces pcl::VoxelGrid, frame.cpp:217-238):
    keeps one representative point per occupied voxel via hash-dedup.

    Returns (pts, keep_mask) — same length, padded semantics preserved."""
    q = jnp.floor(pts / cell).astype(jnp.int32)
    # hash voxel coords; first point per hash wins
    h = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349663) ^ (q[:, 2] * 83492791)
    h = jnp.where(valid, h, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(h)
    sorted_h = h[order]
    first = jnp.concatenate([
        jnp.ones((1,), bool), sorted_h[1:] != sorted_h[:-1]
    ])
    keep_sorted = first & (sorted_h != jnp.iinfo(jnp.int32).max)
    keep = jnp.zeros_like(valid).at[order].set(keep_sorted)
    return pts, keep & valid
