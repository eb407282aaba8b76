"""Test harness: the suite runs on the CPU backend with a virtual 8-device
platform, so multi-device sharding tests run without accelerators.  Tests
that need the GPU carry the `gpu` marker and ask for the `gpu` fixture,
which skips them when JAX finds no GPU; `python chip_smoke.py` runs what
they cover on the card.
"""

import os

# must be set before jax is imported anywhere
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run `python chip_smoke.py` on the card)")


# The suite compiles hundreds of large CPU executables; holding all of them
# live for ~190 tests exhausts process resources (deterministic SIGSEGV in
# XLA around test #157 regardless of which tests ran).  Dropping the
# in-memory jit caches every N tests caps the footprint; the persistent
# compile cache (the package keeps it in the checkout's .jax_cache) makes
# re-tracing a cheap deserialization, not a recompile.
_TEARDOWN_COUNT = 0


def pytest_runtest_teardown(item, nextitem):
    global _TEARDOWN_COUNT
    _TEARDOWN_COUNT += 1
    if _TEARDOWN_COUNT % 30 == 0:
        import gc

        import jax

        jax.clear_caches()
        gc.collect()
