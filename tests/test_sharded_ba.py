"""Distributed BA on the virtual 8-device CPU mesh: result must match the
single-device Schur solver."""

import jax
import numpy as np
import pytest

from aslam.config import BAConfig, CameraModel
from aslam.ops import lba
from aslam.parallel import mesh as mesh_mod
from aslam.parallel import sharded_ba

from tests.test_lba import CAM, CFG, cam_errors, make_ba_problem


def test_factor_devices():
    assert mesh_mod.factor_devices(8) == (2, 4) or mesh_mod.factor_devices(8) == (4, 2)
    assert mesh_mod.factor_devices(1) == (1, 1)
    dp, lm = mesh_mod.factor_devices(6)
    assert dp * lm == 6


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (1, 8)])
def test_sharded_matches_single_device(rng, shape):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    prob, T_true, pts_true, _ = make_ba_problem(rng, n_cams=5, n_pts=64)
    mesh = mesh_mod.make_mesh(8, dp=shape[0], lm=shape[1])

    ref_out, ref_stats = lba.local_ba(prob, CAM, CFG)
    padded = sharded_ba.pad_problem(prob, mesh)
    out, chi2, n_edges = sharded_ba.sharded_local_ba(padded, CAM, CFG, mesh)

    # same camera solution (both run the same schedule on the same data)
    np.testing.assert_allclose(
        np.asarray(out.cam_T), np.asarray(ref_out.cam_T), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(out.points)[:64], np.asarray(ref_out.points), atol=1e-3
    )
    assert int(n_edges) == int(ref_stats.n_edges)
    assert np.isclose(float(chi2), float(ref_stats.chi2), rtol=0.05)


def test_sharded_converges(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    prob, T_true, pts_true, _ = make_ba_problem(rng, n_cams=6, n_pts=96,
                                                cam_noise=0.05)
    mesh = mesh_mod.make_mesh(8)
    padded = sharded_ba.pad_problem(prob, mesh)
    out, chi2, n_edges = sharded_ba.sharded_local_ba(padded, CAM, CFG, mesh)
    dt, dr = cam_errors(out.cam_T, T_true)
    assert dt < 5e-3 and dr < 5e-3
