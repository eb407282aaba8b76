"""Local BA (Schur-complement LM) on synthetic multi-view problems."""

import jax.numpy as jnp
import numpy as np

from aslam.config import BAConfig, CameraModel
from aslam.ops import lba
from aslam.utils import camera, se3

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
CFG = BAConfig(local_iters_1=5, local_iters_2=10)


def make_ba_problem(rng, n_cams=6, n_pts=120, noise_px=0.3, outlier_frac=0.0,
                    cam_noise=0.03, pt_noise=0.02, n_fixed=1):
    """Cameras on a small arc looking at a point cloud; noisy initialization;
    first n_fixed cameras held fixed (gauge)."""
    pts = np.stack([
        rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1, 1, n_pts),
        rng.uniform(2.0, 4.0, n_pts)
    ], -1).astype(np.float32)
    T_true = []
    for i in range(n_cams):
        xi = np.concatenate([
            [0.15 * i, 0.01 * i, 0.0], rng.normal(0, 0.02, 3)
        ]).astype(np.float32)
        T_true.append(np.asarray(se3.se3_exp(jnp.asarray(xi))))
    T_true = np.stack(T_true)

    # observations: every camera sees every point (dense for simplicity)
    e_cam, e_lm, e_uv, e_ur, e_z = [], [], [], [], []
    for c in range(n_cams):
        pc = pts @ T_true[c][:3, :3].T + T_true[c][:3, 3]
        uv, z = camera.project(CAM, jnp.asarray(pc))
        uv = np.asarray(uv) + rng.normal(0, noise_px, (n_pts, 2))
        z = np.asarray(z)
        ur = np.asarray(camera.u_right(CAM, jnp.asarray(uv[:, 0]), jnp.asarray(z)))
        for l in range(n_pts):
            e_cam.append(c); e_lm.append(l)
            e_uv.append(uv[l]); e_ur.append(ur[l]); e_z.append(z[l])
    E = len(e_cam)
    n_out = int(E * outlier_frac)
    out_sel = rng.choice(E, n_out, replace=False)
    e_uv = np.asarray(e_uv, np.float32)
    e_uv[out_sel] += rng.uniform(15, 40, (n_out, 2)).astype(np.float32)

    # noisy initial state (keep fixed cams at truth: they are the gauge)
    cam_T0 = T_true.copy()
    for c in range(n_fixed, n_cams):
        xi = rng.normal(0, cam_noise, 6).astype(np.float32)
        cam_T0[c] = np.asarray(se3.se3_exp(jnp.asarray(xi))) @ T_true[c]
    pts0 = pts + rng.normal(0, pt_noise, pts.shape).astype(np.float32)

    prob = lba.BAProblem(
        cam_T=jnp.asarray(cam_T0),
        cam_fixed=jnp.asarray(np.arange(n_cams) < n_fixed),
        cam_valid=jnp.ones(n_cams, bool),
        points=jnp.asarray(pts0),
        point_valid=jnp.ones(n_pts, bool),
        e_cam=jnp.asarray(e_cam, jnp.int32),
        e_lm=jnp.asarray(e_lm, jnp.int32),
        e_uv=jnp.asarray(e_uv),
        e_ur=jnp.asarray(np.asarray(e_ur, np.float32)),
        e_z=jnp.asarray(np.asarray(e_z, np.float32)),
        e_valid=jnp.ones(E, bool),
    )
    return prob, T_true, pts, out_sel


def cam_errors(T_est, T_true):
    dts, drs = [], []
    for a, b in zip(np.asarray(T_est), T_true):
        d = np.linalg.inv(a) @ b
        dts.append(np.linalg.norm(d[:3, 3]))
        drs.append(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
    return np.max(dts), np.max(drs)


def test_local_ba_reduces_error(rng):
    prob, T_true, pts_true, _ = make_ba_problem(rng)
    dt0, dr0 = cam_errors(prob.cam_T, T_true)
    out, stats = lba.local_ba(prob, CAM, CFG)
    dt1, dr1 = cam_errors(out.cam_T, T_true)
    assert dt1 < dt0 * 0.2, f"{dt0} -> {dt1}"
    assert dt1 < 5e-3
    assert dr1 < 5e-3
    # points should be pulled toward truth
    pt_err0 = np.linalg.norm(np.asarray(prob.points) - pts_true, axis=1).mean()
    pt_err1 = np.linalg.norm(np.asarray(out.points) - pts_true, axis=1).mean()
    assert pt_err1 < pt_err0 * 0.5  # noise floor ~1 cm at 0.3 px obs noise
    assert int(stats.n_edges) == len(np.asarray(prob.e_cam))


def test_local_ba_exact_on_clean_data(rng):
    """Noise-free observations: BA must converge to machine precision."""
    prob, T_true, pts_true, _ = make_ba_problem(rng, noise_px=0.0)
    out, _ = lba.local_ba(prob, CAM, CFG)
    dt, dr = cam_errors(out.cam_T, T_true)
    assert dt < 1e-5 and dr < 1e-3
    pt_err = np.linalg.norm(np.asarray(out.points) - pts_true, axis=1).max()
    assert pt_err < 1e-4


def test_local_ba_fixed_cams_stay_fixed(rng):
    prob, T_true, _, _ = make_ba_problem(rng, n_fixed=2)
    out, _ = lba.local_ba(prob, CAM, CFG)
    np.testing.assert_array_equal(
        np.asarray(out.cam_T[:2]), np.asarray(prob.cam_T[:2])
    )


def test_local_ba_prunes_outliers(rng):
    prob, T_true, _, out_sel = make_ba_problem(rng, outlier_frac=0.1)
    out, stats = lba.local_ba(prob, CAM, CFG)
    e_valid = np.asarray(out.e_valid)
    # most injected outlier edges pruned
    assert (~e_valid[out_sel]).mean() > 0.9
    dt1, dr1 = cam_errors(out.cam_T, T_true)
    assert dt1 < 0.01 and dr1 < 0.01


def test_local_ba_chi2_decreases(rng):
    prob, _, _, _ = make_ba_problem(rng, cam_noise=0.05)
    _, _, _, _, chi2_before, active = lba.edge_terms(prob, CAM, CFG, robust=False)
    before = float(jnp.sum(jnp.where(active, chi2_before, 0.0)))
    _, stats = lba.local_ba(prob, CAM, CFG)
    assert float(stats.chi2) < before * 0.1
