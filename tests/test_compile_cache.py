"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when it is set,
otherwise the checkout's .jax_cache."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("set_var", [True, False])
def test_compile_cache_dir(tmp_path, set_var):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    expected = os.path.join(REPO, ".jax_cache")
    if set_var:
        expected = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = expected
    code = ("import jax, aslam; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(aslam.CACHE_DIR)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(env, PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=120, check=True)
    assert r.stdout.split() == [expected, expected]
