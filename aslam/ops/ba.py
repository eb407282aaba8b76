"""Bundle-adjustment kernels: residuals, Jacobians, robust weights, and the
motion-only (pose-only) solver.

Replaces `PnPSolver::Compute` (reference pnpsolver.cpp:17-213), which runs
g2o Levenberg-Marquardt with one SE3 vertex and unary mono/stereo
reprojection edges: information = I/z^2 (pnpsolver.cpp:74-75,111-112), Huber
deltas sqrt(5.991)/sqrt(7.815), **4 rounds x 10 iterations** with chi^2
inlier reclassification between rounds and the robust kernel dropped in the
final round (pnpsolver.cpp:144-205).

Batched design: all edges are evaluated as one batched computation
(residual/Jacobian arrays [N, ...]), the 6x6 normal equations are built by
einsum reductions, and the iteration loop is a `lax.fori_loop` — no
per-edge graph objects.  The pose is parameterized by left-multiplicative
se(3) increments: T <- exp(xi) * T.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import BAConfig, CameraModel
from aslam.ops.linalg import chol_solve
from aslam.utils.se3 import T_inv, se3_exp, se3_log


class PoseBAResult(NamedTuple):
    T_cw: jnp.ndarray      # [4,4] refined pose
    inliers: jnp.ndarray   # [N] bool final chi2 classification
    n_inliers: jnp.ndarray # scalar int32
    chi2: jnp.ndarray      # [N] final per-edge chi2


def project_residual_jac(
    T_cw: jnp.ndarray,    # [4,4]
    pts_w: jnp.ndarray,   # [N,3]
    obs_uv: jnp.ndarray,  # [N,2]
    obs_ur: jnp.ndarray,  # [N] right-image u (pseudo-stereo), <0 = mono edge
    cam: CameraModel,
):
    """Batched residuals + Jacobians for (pseudo-)stereo reprojection edges.

    Returns (r [N,3], J_pose [N,3,6], J_point [N,3,3], depth_pos [N]):
      r rows are (u, v, uR) errors; for mono edges the uR row is zeroed by
      the caller via the stereo mask.  J_pose is w.r.t. the left-mult twist
      [rho, phi]; J_point w.r.t. the world point (used by local BA).
    """
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    p = pts_w @ R.T + t                      # [N,3] camera-frame
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z

    r = jnp.stack(
        [u - obs_uv[:, 0], v - obs_uv[:, 1], ur - obs_ur], axis=-1
    )

    # d(u,v,ur)/dp  [N,3,3]
    zeros = jnp.zeros_like(x)
    du = jnp.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], -1)
    dv = jnp.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], -1)
    dur = du + jnp.stack([zeros, zeros, cam.bf * inv_z2], -1)
    dproj = jnp.stack([du, dv, dur], axis=1)

    # dp/dxi = [I | -p^] for left-mult twist [rho, phi]   [N,3,6]
    eye = jnp.broadcast_to(jnp.eye(3), (p.shape[0], 3, 3))
    px = jnp.stack(
        [
            jnp.stack([zeros, p[:, 2], -p[:, 1]], -1),
            jnp.stack([-p[:, 2], zeros, p[:, 0]], -1),
            jnp.stack([p[:, 1], -p[:, 0], zeros], -1),
        ],
        axis=1,
    )
    dp_dxi = jnp.concatenate([eye, px], axis=-1)

    J_pose = dproj @ dp_dxi                  # [N,3,6]
    J_point = dproj @ R[None, :, :]          # [N,3,3] via dp/dpw = R
    return r, J_pose, J_point, z > 1e-3


def huber_weight(chi2: jnp.ndarray, delta_sq: jnp.ndarray) -> jnp.ndarray:
    """Huber IRLS weight as a function of the chi2 value (= squared
    whitened residual): 1 inside the delta, delta/|e| outside."""
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    d = jnp.sqrt(delta_sq)
    return jnp.where(chi2 <= delta_sq, 1.0, d / e)


@functools.partial(jax.jit, static_argnames=("cam", "cfg"))
def pose_only_ba(
    T_cw_init: jnp.ndarray,  # [4,4]
    pts_w: jnp.ndarray,      # [N,3] landmark world positions
    obs_uv: jnp.ndarray,     # [N,2] measured keypoint (undistorted)
    obs_ur: jnp.ndarray,     # [N] measured right-u; <0 => mono edge
    obs_z: jnp.ndarray,      # [N] measured depth (for information 1/z^2)
    valid: jnp.ndarray,      # [N] bool
    cam: CameraModel,
    cfg: BAConfig,
    prior_weight: jnp.ndarray | float = 0.0,
) -> PoseBAResult:
    """Motion-only BA: optimize T_cw holding landmarks fixed.

    `prior_weight` > 0 adds a motion-prior edge anchored at T_cw_init
    with information prior_weight * diag(1,1,1, 4,4,4) — an odometry/map
    FUSION term with no reference counterpart (the reference's
    TrackLocalMap lets reprojection edges fully re-solve the pose,
    pnpsolver.cpp:17-213).  Map landmarks carry frozen single-view depth
    noise (sigma_z = 0.01 z^2, ~4-9 cm at 2-3 m); with fast landmark
    turnover (forward/rotating motion) an unconstrained re-solve walks
    randomly with that noise — measurably 15-20x worse than pure VO on
    hard loop scenes (scripts/slam_matrix.py, r3 diagnosis).  The prior
    bounds the per-frame pull to what reprojection evidence justifies
    against the odometry confidence, while persistent evidence (a revisit
    with hundreds of consistent old landmarks) still overcomes it and
    corrects drift."""
    N = pts_w.shape[0]
    prior_w = jnp.asarray(prior_weight, jnp.float32)
    # rotation block stiffer: 1 rad of rotation moves the scene ~z meters
    # at depth z, so a (m^-2, rad^-2) diagonal of (1, 4) roughly equalizes
    # the two blocks' pixel-space leverage at the 2-3 m working depth
    H_prior = prior_w * jnp.diag(
        jnp.asarray([1.0, 1.0, 1.0, 4.0, 4.0, 4.0], jnp.float32))
    is_stereo = obs_ur >= 0
    if cfg.info_model == "constant":
        # constant pixel-noise model; depth-less observations keep their
        # u,v rows (see lba.edge_terms)
        info = jnp.ones_like(obs_z)
    else:
        # information 1/z^2 (pnpsolver.cpp:74-75); z<=0 edges get weight ~0
        info = jnp.where(obs_z > 1e-3,
                         1.0 / jnp.maximum(obs_z, 1e-3) ** 2, 0.0)
    chi2_th = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)

    def edge_terms(T, inlier_mask, robust):
        r, J, _, depth_ok = project_residual_jac(T, pts_w, obs_uv, obs_ur, cam)
        row_mask = jnp.stack(
            [jnp.ones((N,), bool), jnp.ones((N,), bool), is_stereo], -1
        )
        r = jnp.where(row_mask, r, 0.0)
        chi2 = jnp.sum(r * r, -1) * info
        w_huber = jnp.where(robust, huber_weight(chi2, chi2_th), 1.0)
        w = info * w_huber * (valid & inlier_mask & depth_ok)
        H = jnp.einsum("n,nri,nrj->ij", w, J, J)
        b = jnp.einsum("n,nri,nr->i", w, J, r)
        return H, b, chi2

    T_prior_inv = T_inv(T_cw_init)

    def solve_round(T, inlier_mask, robust):
        def body(_, carry):
            T, lam = carry
            H, b, _ = edge_terms(T, inlier_mask, robust)
            # motion-prior edge: r_p = log(T * T_init^-1) (left-mult twist
            # taking T back to the odometry anchor), J = I to first order
            r_p = se3_log(T @ T_prior_inv)
            H = H + H_prior
            b = b + H_prior @ r_p
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            xi = -chol_solve(Hd, b)
            # guard: reject steps that are non-finite
            xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
            return (se3_exp(xi) @ T, lam)

        T, _ = jax.lax.fori_loop(0, cfg.pose_iters, body, (T, 1e-4))
        _, _, chi2 = edge_terms(T, inlier_mask, robust)
        return T, chi2

    T = T_cw_init
    inlier_mask = jnp.ones((N,), bool)
    for rnd in range(cfg.pose_rounds):
        robust = rnd < cfg.pose_rounds - 1  # kernel dropped in final round
        T, chi2 = solve_round(T, inlier_mask, robust)
        inlier_mask = chi2 <= chi2_th       # reclassification between rounds

    final_inliers = valid & inlier_mask
    return PoseBAResult(
        T_cw=T,
        inliers=final_inliers,
        n_inliers=jnp.sum(final_inliers.astype(jnp.int32)),
        chi2=chi2,
    )
