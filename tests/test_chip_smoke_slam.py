"""chip_smoke.py's SLAM, CLI and four-card phases at test capacity on the
CPU (the card runs them at full width; four virtual devices stand in for
the four cards)."""

import jax
import pytest

import chip_smoke
from aslam import main as cli
from aslam import workloads


def test_phase_slam_small():
    # the 320x240 test camera tracks coarser than the full-width sensor
    out = chip_smoke.phase_slam(workloads.small_config(), n_frames=33,
                                chunk=16, ate_limit_m=0.02)
    assert out["n_kfs"] > 1 and out["fps"] > 0


def test_phase_cli_small(monkeypatch):
    monkeypatch.setitem(cli.CAMERAS, "small",
                        workloads.small_config().camera)
    out = chip_smoke.phase_cli(n_frames=9, chunk=4, camera="small",
                               ate_limit_m=0.02)
    assert out["ate_m"] <= 0.02


def test_phase_cli_rejects_distorted_camera():
    with pytest.raises(RuntimeError, match="distortion"):
        chip_smoke.phase_cli(n_frames=3, chunk=2, camera="fr1")


def test_phase_four_cards_virtual_mesh():
    out = chip_smoke.phase_four_cards(jax.devices()[:4], n_kfs=64,
                                      n_feats=64,
                                      lba_cfg=workloads.small_config())
    assert out["chi2_sh"] < out["chi2_0"] and out["chi2_post"] < out["chi2_0"]
    assert max(out["gn_cg_dT"], out["gn_cg_dX"], out["lba_dT"],
               out["lba_dX"]) <= 1e-3
