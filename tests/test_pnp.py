import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import CameraModel
from aslam.ops import pnp
from aslam.utils import camera, se3

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)


def make_problem(rng, n=120, outlier_frac=0.3, pose_err=0.08, noise_px=0.5):
    pts = np.stack([
        rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(1.5, 4, n)
    ], -1).astype(np.float32)
    T_true = np.asarray(se3.se3_exp(jnp.asarray(
        rng.normal(0, 0.1, 6).astype(np.float32))))
    uv, z = camera.project(CAM, jnp.asarray(pts @ T_true[:3, :3].T + T_true[:3, 3]))
    uv = np.array(uv) + rng.normal(0, noise_px, (n, 2))
    n_out = int(n * outlier_frac)
    sel = rng.choice(n, n_out, replace=False)
    uv[sel] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T_init = np.asarray(se3.se3_exp(jnp.asarray(
        rng.normal(0, pose_err, 6).astype(np.float32)))) @ T_true
    gt_inl = np.ones(n, bool)
    gt_inl[sel] = False
    return pts, uv.astype(np.float32), T_true, T_init, gt_inl


def test_pnp_ransac_recovers_pose(rng):
    pts, uv, T_true, T_init, gt_inl = make_problem(rng)
    res = pnp.pnp_ransac(
        jnp.asarray(pts), jnp.asarray(uv), jnp.ones(len(pts), bool),
        jnp.asarray(T_init), jax.random.PRNGKey(0), CAM,
    )
    assert bool(res.ok)
    T = np.asarray(res.T_cw)
    dt = np.linalg.norm(T[:3, 3] - T_true[:3, 3])
    assert dt < 0.01, f"translation error {dt}"
    est = np.asarray(res.inliers)
    assert (est == gt_inl).mean() > 0.9


def test_pnp_ransac_prior_rescue(rng):
    """All-outlier observations: prior pose survives, ok=False."""
    pts, uv, T_true, T_init, _ = make_problem(rng, outlier_frac=1.0)
    res = pnp.pnp_ransac(
        jnp.asarray(pts), jnp.asarray(uv), jnp.ones(len(pts), bool),
        jnp.asarray(T_init), jax.random.PRNGKey(1), CAM,
    )
    assert not bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.T_cw), T_init, atol=1e-6)
