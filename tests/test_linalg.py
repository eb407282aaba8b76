"""Batched SPD Cholesky solves vs jnp.linalg reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aslam.ops.linalg import chol_inv, chol_solve


def _random_spd(rng, batch, n, damp=1e-3):
    G = rng.normal(size=(*batch, n, n)).astype(np.float32)
    A = G @ np.swapaxes(G, -1, -2) + damp * np.eye(n, dtype=np.float32)
    return A


@pytest.mark.parametrize("n", [3, 6])
def test_chol_solve_matches_lu(n):
    rng = np.random.default_rng(0)
    A = _random_spd(rng, (257,), n)
    b = rng.normal(size=(257, n)).astype(np.float32)
    x = chol_solve(jnp.asarray(A), jnp.asarray(b))
    x_ref = jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)[..., None])[..., 0]
    # residual-based check (matrices can be ill-conditioned at f32)
    res = np.einsum("bij,bj->bi", A, np.asarray(x)) - b
    res_ref = np.einsum("bij,bj->bi", A, np.asarray(x_ref)) - b
    assert np.linalg.norm(res) <= 2.0 * np.linalg.norm(res_ref) + 1e-4


@pytest.mark.parametrize("n", [3, 6])
def test_chol_inv_matches(n):
    rng = np.random.default_rng(1)
    A = _random_spd(rng, (64,), n, damp=1e-2)
    Ainv = np.asarray(chol_inv(jnp.asarray(A)))
    eye = np.einsum("bij,bjk->bik", A, Ainv)
    np.testing.assert_allclose(eye, np.tile(np.eye(n), (64, 1, 1)),
                               atol=5e-3)


def test_chol_solve_damped_singular_rows():
    # padded/invalid BA rows: pure damping (scaled identity) — must stay
    # finite, exact answer b/lam
    lam = 1e-4
    A = jnp.tile(lam * jnp.eye(6), (8, 1, 1))
    b = jnp.ones((8, 6))
    x = chol_solve(A, b)
    assert bool(jnp.all(jnp.isfinite(x)))
    np.testing.assert_allclose(np.asarray(x), np.full((8, 6), 1.0 / lam),
                               rtol=1e-5)


def test_chol_solve_multi_batch_dims():
    rng = np.random.default_rng(2)
    A = _random_spd(rng, (4, 5), 3)
    b = rng.normal(size=(4, 5, 3)).astype(np.float32)
    x = chol_solve(jnp.asarray(A), jnp.asarray(b))
    x_ref = jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=5e-3, atol=5e-3)


def test_chol_solve_jit_and_grad_free_path():
    # must trace cleanly under jit (used inside the jitted BA programs)
    rng = np.random.default_rng(3)
    A = jnp.asarray(_random_spd(rng, (16,), 6))
    b = jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))
    x = jax.jit(chol_solve)(A, b)
    assert x.shape == (16, 6)
