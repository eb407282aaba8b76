"""chip_smoke.py: refusal without a GPU, and its front-end phases at
`workloads.small_config()` on the CPU (the card runs them at full width)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from aslam import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--four-cards"])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu(tmp_path, alone):
    """As the command line runs it: from the checkout, and from a directory
    that holds chip_smoke.py and nothing else of the repository."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_hamming_reference_is_popcount(rng):
    a = rng.integers(0, 2**32, (5, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (6, 8), dtype=np.uint32)
    expect = [[sum(bin(int(x) ^ int(y)).count("1") for x, y in zip(p, q))
               for q in b] for p in a]
    np.testing.assert_array_equal(chip_smoke.hamming_reference(a, b), expect)


def test_phase_parity_small():
    cpu = jax.devices("cpu")
    out = chip_smoke.phase_parity(workloads.small_config(), cpu[0], cpu[1])
    assert out["kp_share"] == 1.0 and out["lba_rel"] <= 1e-6
    assert out["knn_us"] > 0 and out["proj_us"] > 0


def test_phase_vo_small():
    out = chip_smoke.phase_vo(workloads.small_config(), n_chunks=2, chunk=8)
    assert out["ate_m"] <= chip_smoke.ATE_LIMIT_M and out["fps"] > 0


@pytest.mark.gpu
def test_phase_parity_full_width(gpu):
    out = chip_smoke.phase_parity(workloads.full_config(), gpu,
                                  jax.devices("cpu")[0])
    assert out["kp_share"] >= 0.99
