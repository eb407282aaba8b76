import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import BAConfig, CameraModel
from aslam.ops import ba
from aslam.utils import camera, se3

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
CFG = BAConfig()


def make_problem(rng, n=150, noise_px=0.3, outlier_frac=0.0, pose_err=0.05):
    pts_w = np.stack([
        rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(1.0, 4.0, n)
    ], -1).astype(np.float32)
    xi_true = rng.normal(0, 0.05, 6).astype(np.float32)
    T_true = np.asarray(se3.se3_exp(jnp.asarray(xi_true)))
    uv, z = camera.project(CAM, jnp.asarray(pts_w @ T_true[:3, :3].T + T_true[:3, 3]))
    uv = np.asarray(uv) + rng.normal(0, noise_px, (n, 2))
    z = np.asarray(z)
    ur = np.asarray(camera.u_right(CAM, jnp.asarray(uv[:, 0]), jnp.asarray(z)))
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(20, 60, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    xi_perturb = rng.normal(0, pose_err, 6).astype(np.float32)
    T_init = np.asarray(se3.se3_exp(jnp.asarray(xi_perturb))) @ T_true
    inl = np.ones(n, bool)
    inl[out_idx] = False
    return T_true, T_init, pts_w, uv.astype(np.float32), ur, z, inl


def pose_error(T_est, T_true):
    d = np.asarray(se3.T_inv(jnp.asarray(T_est))) @ T_true
    return np.linalg.norm(d[:3, 3]), float(np.asarray(se3.rotation_angle(jnp.asarray(d[:3, :3]))))


def run(T_init, pts, uv, ur, z, valid=None):
    n = len(pts)
    valid = np.ones(n, bool) if valid is None else valid
    return ba.pose_only_ba(
        jnp.asarray(T_init), jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(ur),
        jnp.asarray(z), jnp.asarray(valid), CAM, CFG,
    )


def test_pose_ba_converges_clean(rng):
    T_true, T_init, pts, uv, ur, z, _ = make_problem(rng)
    res = run(T_init, pts, uv, ur, z)
    dt, dr = pose_error(np.asarray(res.T_cw), T_true)
    assert dt < 2e-3, f"translation error {dt}"
    assert dr < 2e-3, f"rotation error {dr}"
    assert int(res.n_inliers) > 140


def test_pose_ba_robust_to_outliers(rng):
    T_true, T_init, pts, uv, ur, z, inl_true = make_problem(rng, outlier_frac=0.3)
    res = run(T_init, pts, uv, ur, z)
    dt, dr = pose_error(np.asarray(res.T_cw), T_true)
    assert dt < 5e-3, f"translation error {dt}"
    assert dr < 5e-3, f"rotation error {dr}"
    est_inl = np.asarray(res.inliers)
    assert (est_inl == inl_true).mean() > 0.95


def test_pose_ba_mono_edges(rng):
    """Edges with ur<0 are mono: should still converge."""
    T_true, T_init, pts, uv, ur, z, _ = make_problem(rng)
    ur = np.full_like(ur, -1.0)  # all mono
    res = run(T_init, pts, uv, ur, z)
    dt, dr = pose_error(np.asarray(res.T_cw), T_true)
    assert dt < 5e-3 and dr < 5e-3


def test_pose_ba_respects_valid_mask(rng):
    T_true, T_init, pts, uv, ur, z, _ = make_problem(rng, n=100)
    # poison half the observations but mark them invalid
    uv2 = uv.copy()
    uv2[50:] += 500.0
    valid = np.zeros(100, bool)
    valid[:50] = True
    res = run(T_init, pts, uv2, ur, z, valid)
    dt, dr = pose_error(np.asarray(res.T_cw), T_true)
    assert dt < 5e-3 and dr < 5e-3
    assert not np.asarray(res.inliers)[50:].any()


def test_jacobian_matches_autodiff(rng):
    """Analytic pose Jacobian vs jax.jacfwd of the residual (SURVEY.md §4:
    verify Jacobians against autodiff)."""
    pts = np.stack([
        rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20), rng.uniform(1, 3, 20)
    ], -1).astype(np.float32)
    T0 = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(0, 0.1, 6).astype(np.float32))))
    uv, z = camera.project(CAM, jnp.asarray(pts @ T0[:3, :3].T + T0[:3, 3]))
    ur = camera.u_right(CAM, uv[:, 0], z)
    obs_uv = np.asarray(uv) + 1.0  # offset so residual nonzero
    obs_ur = np.asarray(ur) + 0.5

    r0, J, _, _ = ba.project_residual_jac(
        jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs_uv), jnp.asarray(obs_ur), CAM
    )

    def residual_of_xi(xi):
        T = se3.se3_exp(xi) @ jnp.asarray(T0)
        r, _, _, _ = ba.project_residual_jac(
            T, jnp.asarray(pts), jnp.asarray(obs_uv), jnp.asarray(obs_ur), CAM
        )
        return r

    J_auto = jax.jacfwd(residual_of_xi)(jnp.zeros(6))
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_auto), atol=2e-2, rtol=1e-2)


def test_point_jacobian_matches_autodiff(rng):
    pts = np.stack([
        rng.uniform(-1, 1, 5), rng.uniform(-1, 1, 5), rng.uniform(1, 3, 5)
    ], -1).astype(np.float32)
    T0 = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(0, 0.1, 6).astype(np.float32))))
    obs_uv = np.zeros((5, 2), np.float32)
    obs_ur = np.zeros(5, np.float32)
    _, _, Jp, _ = ba.project_residual_jac(
        jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs_uv), jnp.asarray(obs_ur), CAM
    )

    def residual_of_pts(p):
        r, _, _, _ = ba.project_residual_jac(
            jnp.asarray(T0), p, jnp.asarray(obs_uv), jnp.asarray(obs_ur), CAM
        )
        return r

    J_auto = jax.jacfwd(residual_of_pts)(jnp.asarray(pts))
    # extract block-diagonal [i,:, i,:]
    J_auto_diag = np.stack([np.asarray(J_auto)[i, :, i, :] for i in range(5)])
    np.testing.assert_allclose(np.asarray(Jp), J_auto_diag, atol=2e-2, rtol=1e-2)
