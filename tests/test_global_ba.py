"""Global BA (alternating sweeps) on a noisy synthetic map."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import mapstate as ms
from aslam.ops import global_ba
from aslam.utils import camera, se3


def build_noisy_map(rng, n_kfs=8, n_pts=200, pose_noise=0.02, pt_noise=0.02,
                    obs_noise_px=0.2):
    cfg = small_config()
    cam = cfg.camera
    M = cfg.extractor.max_keypoints
    pts_true = np.stack([
        rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1, 1, n_pts),
        rng.uniform(1.5, 3.5, n_pts),
    ], -1).astype(np.float32)
    T_true = []
    for i in range(n_kfs):
        xi = np.concatenate([[0.1 * i, 0.0, 0.0],
                             rng.normal(0, 0.01, 3)]).astype(np.float32)
        T_true.append(np.asarray(se3.se3_exp(jnp.asarray(xi))))
    T_true = np.stack(T_true)

    m = ms.init_map(cfg)
    for k in range(n_kfs):
        pc = pts_true @ T_true[k][:3, :3].T + T_true[k][:3, 3]
        uv, z = camera.project(cam, jnp.asarray(pc))
        uv = np.asarray(uv) + rng.normal(0, obs_noise_px, (n_pts, 2)).astype(np.float32)
        z = np.asarray(z)
        n_f = min(n_pts, M)
        kf_xy = np.zeros((M, 2), np.float32); kf_xy[:n_f] = uv[:n_f]
        kf_z = np.zeros(M, np.float32); kf_z[:n_f] = z[:n_f]
        kp_valid = np.zeros(M, bool); kp_valid[:n_f] = True
        assoc = np.full(M, -1, np.int32); assoc[:n_f] = np.arange(n_f)
        ur = np.where(kf_z > 0, kf_xy[:, 0] - cam.bf / np.maximum(kf_z, 1e-6), -1.0)
        T_n = T_true[k].copy()
        if k > 0:
            T_n = np.asarray(se3.se3_exp(jnp.asarray(
                rng.normal(0, pose_noise, 6).astype(np.float32)))) @ T_n
        m = m._replace(
            kf_T_cw=m.kf_T_cw.at[k].set(jnp.asarray(T_n)),
            kf_valid=m.kf_valid.at[k].set(True),
            kf_id=m.kf_id.at[k].set(k),
            kf_xy=m.kf_xy.at[k].set(jnp.asarray(kf_xy)),
            kf_ur=m.kf_ur.at[k].set(jnp.asarray(ur.astype(np.float32))),
            kf_z=m.kf_z.at[k].set(jnp.asarray(kf_z)),
            kf_kp_valid=m.kf_kp_valid.at[k].set(jnp.asarray(kp_valid)),
            kf_lm=m.kf_lm.at[k].set(jnp.asarray(assoc)),
        )
    pts_noisy = pts_true + rng.normal(0, pt_noise, pts_true.shape).astype(np.float32)
    m = m._replace(
        lm_pos=m.lm_pos.at[:n_pts].set(jnp.asarray(pts_noisy)),
        lm_valid=m.lm_valid.at[:n_pts].set(True),
    )
    m = ms.rebuild_observer_index(m)
    return cfg, m, T_true, pts_true, n_kfs, n_pts


def test_global_ba_reduces_error(rng):
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng)
    err_T0 = max(
        np.linalg.norm(np.asarray(m.kf_T_cw)[k][:3, 3] - T_true[k][:3, 3])
        for k in range(1, n_kfs)
    )
    err_p0 = np.linalg.norm(
        np.asarray(m.lm_pos)[:n_pts] - pts_true, axis=1).mean()

    out, stats = global_ba.global_ba(m, cfg.camera, cfg.ba, iters=30,
                                     robust_iters=10)
    err_T1 = max(
        np.linalg.norm(np.asarray(out.kf_T_cw)[k][:3, 3] - T_true[k][:3, 3])
        for k in range(1, n_kfs)
    )
    err_p1 = np.linalg.norm(
        np.asarray(out.lm_pos)[:n_pts] - pts_true, axis=1).mean()
    assert err_T1 < err_T0 * 0.5, f"poses {err_T0:.4f} -> {err_T1:.4f}"
    assert err_p1 < err_p0 * 0.6, f"points {err_p0:.4f} -> {err_p1:.4f}"
    # gauge KF untouched
    np.testing.assert_allclose(
        np.asarray(out.kf_T_cw)[0], np.asarray(m.kf_T_cw)[0], atol=1e-6
    )


def test_global_ba_chi2_monotone_overall(rng):
    cfg, m, *_ = build_noisy_map(rng)
    _, s0 = global_ba.ba_sweep(m, cfg.camera, cfg.ba, robust=False)
    out, s_final = global_ba.global_ba(m, cfg.camera, cfg.ba, iters=15,
                                       robust_iters=5)
    assert float(s_final.chi2) < float(s0.chi2)


def test_chunked_sweep_matches_dense(rng):
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng)
    dense, s1 = global_ba.ba_sweep(m, cfg.camera, cfg.ba, robust=True)
    K = m.kf_T_cw.shape[0]
    chunked, s2 = global_ba.ba_sweep_chunked(m, cfg.camera, cfg.ba,
                                             robust=True, kf_chunk=K // 4)
    np.testing.assert_allclose(np.asarray(chunked.kf_T_cw),
                               np.asarray(dense.kf_T_cw), atol=1e-5)
    np.testing.assert_allclose(np.asarray(chunked.lm_pos),
                               np.asarray(dense.lm_pos), atol=1e-5)
    assert int(s1.n_edges) == int(s2.n_edges)
    assert np.isclose(float(s1.chi2), float(s2.chi2), rtol=1e-4)


def test_gn_cg_step_converges_faster_than_sweeps(rng):
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng)

    sweeps = m
    for i in range(4):
        sweeps, s_sw = global_ba.ba_sweep(sweeps, cfg.camera, cfg.ba,
                                          robust=(i < 2))
    cg = m
    for i in range(4):
        cg, s_cg = global_ba.gn_cg_step(cg, cfg.camera, cfg.ba,
                                        robust=(i < 2), cg_iters=32,
                                        kf_chunk=m.kf_lm.shape[0] // 2)
    assert float(s_cg.chi2) <= float(s_sw.chi2) * 1.1

    err_sw = max(np.linalg.norm(np.asarray(sweeps.kf_T_cw)[k][:3, 3]
                                - T_true[k][:3, 3]) for k in range(1, n_kfs))
    err_cg = max(np.linalg.norm(np.asarray(cg.kf_T_cw)[k][:3, 3]
                                - T_true[k][:3, 3]) for k in range(1, n_kfs))
    # joint steps must at least match the alternating half-steps
    assert err_cg <= err_sw * 1.2
    assert err_cg < 5e-3
