import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import CameraModel, RansacConfig
from aslam.ops import ransac
from aslam.utils import se3

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
CFG = RansacConfig(n_hypotheses=64, refine_iters=4, max_matches=256)


def make_problem(rng, n=200, outlier_frac=0.3, noise=0.002,
                 t_scale=0.05, r_scale=0.05):
    xi = np.concatenate([
        rng.normal(0, t_scale, 3), rng.normal(0, r_scale, 3)
    ]).astype(np.float32)
    T12 = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    p1 = np.stack([
        rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(0.8, 3.0, n)
    ], -1).astype(np.float32)
    p2 = p1 @ T12[:3, :3].T + T12[:3, 3]
    p2 += rng.normal(0, noise, p2.shape)
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    p2[out_idx] += rng.uniform(0.3, 1.5, (n_out, 3)) * rng.choice([-1, 1], (n_out, 3))
    inlier_mask = np.ones(n, bool)
    inlier_mask[out_idx] = False
    # pad to pool size
    M = CFG.max_matches
    valid = np.zeros(M, bool)
    valid[:n] = True
    p1p = np.zeros((M, 3), np.float32); p1p[:n] = p1
    p2p = np.zeros((M, 3), np.float32); p2p[:n] = p2
    return T12, p1p, p2p, valid, inlier_mask


def test_ransac_recovers_transform(rng):
    T_true, p1, p2, valid, inliers_true = make_problem(rng)
    res = ransac.ransac_align(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        jax.random.PRNGKey(0), CFG, CAM,
    )
    assert bool(res.ok)
    T = np.asarray(res.T12)
    dt = np.linalg.norm(T[:3, 3] - T_true[:3, 3])
    dr = np.asarray(se3.rotation_angle(jnp.asarray(T[:3, :3] @ T_true[:3, :3].T)))
    assert dt < 0.01, f"translation error {dt}"
    assert dr < 0.01, f"rotation error {dr}"
    # inlier classification should mostly agree
    est_inl = np.asarray(res.inliers)[:200]
    agreement = (est_inl == inliers_true).mean()
    assert agreement > 0.9, f"inlier agreement {agreement}"


def test_ransac_identity_fallback(rng):
    """Nearly-static scene with heavy outliers: identity hypothesis must
    keep the result sane (ransac.cpp:252-264 rescue)."""
    T_true, p1, p2, valid, _ = make_problem(rng, t_scale=0.0, r_scale=0.0,
                                            outlier_frac=0.5)
    res = ransac.ransac_align(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        jax.random.PRNGKey(1), CFG, CAM,
    )
    assert bool(res.ok)
    T = np.asarray(res.T12)
    assert np.linalg.norm(T[:3, 3]) < 0.01


def test_ransac_fails_gracefully_on_garbage(rng):
    M = CFG.max_matches
    p1 = rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    p2 = rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    p1[:, 2] = np.abs(p1[:, 2]) + 0.5
    p2[:, 2] = np.abs(p2[:, 2]) + 0.5
    res = ransac.ransac_align(
        jnp.asarray(p1), jnp.asarray(p2), jnp.ones(M, bool),
        jax.random.PRNGKey(2), CFG, CAM,
    )
    # random clouds: no consistent rigid motion with enough inliers
    assert int(res.n_inliers) < 40


def test_ransac_respects_validity_padding(rng):
    """Only 30 valid matches, rest is padding garbage."""
    T_true, p1, p2, valid, _ = make_problem(rng, n=30, outlier_frac=0.1)
    # poison the padded region
    p1[30:] = rng.uniform(-5, 5, (p1.shape[0] - 30, 3))
    p2[30:] = rng.uniform(-5, 5, (p1.shape[0] - 30, 3))
    res = ransac.ransac_align(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        jax.random.PRNGKey(3), CFG, CAM,
    )
    assert bool(res.ok)
    T = np.asarray(res.T12)
    dt = np.linalg.norm(T[:3, 3] - T_true[:3, 3])
    assert dt < 0.02
    assert not np.asarray(res.inliers)[30:].any()


def test_mahalanobis_gate_scales_with_depth(rng):
    """The same metric offset is more acceptable at far range (bigger cov)."""
    p_near = jnp.asarray([[0.0, 0.0, 0.6]])
    p_far = jnp.asarray([[0.0, 0.0, 3.0]])
    off = jnp.asarray([[0.0, 0.0, 0.02]])
    m_near = np.asarray(ransac.mahalanobis_sq(p_near, p_near + off, jnp.eye(4), CAM, 0.01))
    m_far = np.asarray(ransac.mahalanobis_sq(p_far, p_far + off, jnp.eye(4), CAM, 0.01))
    assert m_near[0] > m_far[0]
