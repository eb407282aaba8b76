import jax
import jax.numpy as jnp
import numpy as np

from aslam.utils import se3


def random_pose(rng, t_scale=1.0, r_scale=1.0):
    xi = np.concatenate([rng.normal(0, t_scale, 3), rng.normal(0, r_scale, 3)])
    return np.asarray(se3.se3_exp(jnp.asarray(xi, jnp.float32)))


def test_exp_log_roundtrip(rng):
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    T = se3.se3_exp(jnp.asarray(xi))
    xi2 = se3.se3_log(T)
    np.testing.assert_allclose(np.asarray(xi2), xi, atol=5e-3)


def test_exp_is_rigid(rng):
    xi = rng.normal(0, 1.0, (8, 6)).astype(np.float32)
    T = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    R = T[:, :3, :3]
    eye = np.einsum("bij,bkj->bik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    np.testing.assert_allclose(T[:, 3], np.tile([0, 0, 0, 1], (8, 1)), atol=0)


def test_inverse(rng):
    T = np.stack([random_pose(rng) for _ in range(5)])
    Ti = np.asarray(se3.T_inv(jnp.asarray(T)))
    prod = np.einsum("bij,bjk->bik", T, Ti)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(4), prod.shape), atol=1e-5)


def test_quat_roundtrip(rng):
    # include rotations near pi
    xi = rng.normal(0, 1.5, (64, 3)).astype(np.float32)
    R = np.asarray(se3.so3_exp(jnp.asarray(xi)))
    q = se3.R_to_quat(jnp.asarray(R))
    R2 = np.asarray(se3.quat_to_R(q))
    np.testing.assert_allclose(R2, R, atol=1e-4)


def test_so3_log_near_pi():
    axis = np.array([1.0, 0.0, 0.0], np.float32)
    R = np.asarray(se3.so3_exp(jnp.asarray(axis * (np.pi - 1e-4))))
    phi = np.asarray(se3.so3_log(jnp.asarray(R)))
    np.testing.assert_allclose(np.linalg.norm(phi), np.pi - 1e-4, atol=1e-2)


def test_weighted_kabsch_exact(rng):
    """Kabsch recovers a known rigid transform exactly (kabsch.cpp parity)."""
    T_true = random_pose(rng, t_scale=0.5, r_scale=0.8)
    src = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    dst = src @ T_true[:3, :3].T + T_true[:3, 3]
    w = np.ones(50, np.float32)
    T_est = np.asarray(se3.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(T_est, T_true, atol=1e-4)


def test_weighted_kabsch_ignores_zero_weight(rng):
    T_true = random_pose(rng, t_scale=0.3, r_scale=0.5)
    src = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    dst = src @ T_true[:3, :3].T + T_true[:3, 3]
    # corrupt half the points but zero their weights
    dst[25:] += rng.normal(0, 5.0, (25, 3))
    w = np.ones(50, np.float32)
    w[25:] = 0.0
    T_est = np.asarray(se3.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(T_est, T_true, atol=1e-4)


def test_weighted_kabsch_batched(rng):
    src = rng.uniform(-1, 1, (7, 20, 3)).astype(np.float32)
    Ts = np.stack([random_pose(rng) for _ in range(7)])
    dst = np.einsum("bij,bnj->bni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    w = np.ones((7, 20), np.float32)
    T_est = np.asarray(se3.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(T_est, Ts, atol=1e-4)


def test_kabsch_reflection_guard(rng):
    """Degenerate planar points must still yield det(R)=+1."""
    src = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    src[:, 2] = 0.0
    T_true = random_pose(rng)
    dst = src @ T_true[:3, :3].T + T_true[:3, 3]
    T_est = np.asarray(
        se3.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.ones(30, jnp.float32))
    )
    assert np.linalg.det(T_est[:3, :3]) > 0.99


def test_jit_and_vmap():
    f = jax.jit(jax.vmap(se3.se3_exp))
    out = f(jnp.zeros((4, 6)))
    np.testing.assert_allclose(np.asarray(out), np.broadcast_to(np.eye(4), (4, 4, 4)))
