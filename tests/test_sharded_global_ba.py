"""Distributed global BA sweeps must match the single-device version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aslam.ops import global_ba
from aslam.parallel import mesh as mesh_mod
from aslam.parallel import sharded_global_ba as sgba

from tests.test_global_ba import build_noisy_map


def test_sharded_matches_single(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng, n_kfs=8,
                                                             n_pts=128)
    mesh = mesh_mod.make_mesh(8, dp=4, lm=2)

    ref = m
    for i in range(6):
        ref, ref_stats = global_ba.ba_sweep(ref, cfg.camera, cfg.ba,
                                            robust=(i < 3))

    padded = sgba.pad_map_for_mesh(m, mesh)
    out, chi2 = sgba.sharded_global_ba(padded, cfg.camera, cfg.ba, mesh,
                                       iters=6, robust_iters=3)
    np.testing.assert_allclose(
        np.asarray(out.kf_T_cw)[:n_kfs], np.asarray(ref.kf_T_cw)[:n_kfs],
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(out.lm_pos)[:n_pts], np.asarray(ref.lm_pos)[:n_pts],
        atol=2e-3,
    )


def test_sharded_global_ba_improves(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng, n_kfs=8,
                                                             n_pts=128)
    mesh = mesh_mod.make_mesh(8)
    padded = sgba.pad_map_for_mesh(m, mesh)
    out, chi2 = sgba.sharded_global_ba(padded, cfg.camera, cfg.ba, mesh,
                                       iters=20, robust_iters=8)
    err0 = max(np.linalg.norm(np.asarray(m.kf_T_cw)[k][:3, 3] - T_true[k][:3, 3])
               for k in range(1, n_kfs))
    err1 = max(np.linalg.norm(np.asarray(out.kf_T_cw)[k][:3, 3] - T_true[k][:3, 3])
               for k in range(1, n_kfs))
    assert err1 < err0 * 0.5


def test_sharded_gn_cg_matches_single(rng):
    import jax

    from aslam.parallel import sharded_gn_cg

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng, n_kfs=8,
                                                             n_pts=128)
    mesh = mesh_mod.make_mesh(8, dp=4, lm=2)

    ref, ref_stats = global_ba.gn_cg_step(
        m, cfg.camera, cfg.ba, robust=True, cg_iters=24,
        kf_chunk=m.kf_lm.shape[0])

    padded = sgba.pad_map_for_mesh(m, mesh)
    out, stats = sharded_gn_cg.sharded_gn_cg_step(
        padded, cfg.camera, cfg.ba, mesh, robust=True, cg_iters=24)

    np.testing.assert_allclose(
        np.asarray(out.kf_T_cw)[:n_kfs], np.asarray(ref.kf_T_cw)[:n_kfs],
        atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(out.lm_pos)[:n_pts], np.asarray(ref.lm_pos)[:n_pts],
        atol=2e-3)
    assert int(stats.n_edges) == int(ref_stats.n_edges)
    assert np.isclose(float(stats.chi2), float(ref_stats.chi2), rtol=0.05)


@pytest.mark.parametrize("shape", [(8, 1), (1, 8)])
def test_sharded_gn_cg_mesh_layouts(rng, shape):
    import jax

    from aslam.parallel import sharded_gn_cg

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(rng, n_kfs=8,
                                                             n_pts=64)
    mesh = mesh_mod.make_mesh(8, dp=shape[0], lm=shape[1])
    padded = sgba.pad_map_for_mesh(m, mesh)
    out, stats = sharded_gn_cg.sharded_gn_cg_step(
        padded, cfg.camera, cfg.ba, mesh, robust=True, cg_iters=16)
    # one step reduces camera error
    err0 = max(np.linalg.norm(np.asarray(m.kf_T_cw)[k][:3, 3] - T_true[k][:3, 3])
               for k in range(1, n_kfs))
    err1 = max(np.linalg.norm(np.asarray(out.kf_T_cw)[k][:3, 3] - T_true[k][:3, 3])
               for k in range(1, n_kfs))
    assert err1 < err0
