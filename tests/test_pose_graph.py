"""Pose-graph optimization: drift correction with a loop edge."""

import jax.numpy as jnp
import numpy as np

from aslam.ops import pose_graph
from aslam.utils import se3


def chain_problem(rng, n=12, drift=0.02):
    """Ground truth: poses along a circle so first ~= last.  Estimates
    accumulate drift; a loop edge ties last to first with truth."""
    # ground-truth relative motions around a loop
    T_gt = [np.eye(4, dtype=np.float32)]
    rel = []
    for i in range(n - 1):
        xi = np.concatenate([
            [0.3, 0.0, 0.0], [0.0, 2 * np.pi / n, 0.0]
        ]).astype(np.float32)
        d = np.asarray(se3.se3_exp(jnp.asarray(xi)))
        rel.append(d)
        T_gt.append((d @ T_gt[-1]).astype(np.float32))
    # drifted odometry estimates
    T_est = [T_gt[0]]
    for i, d in enumerate(rel):
        noise = np.asarray(se3.se3_exp(jnp.asarray(
            rng.normal(0, drift, 6).astype(np.float32))))
        T_est.append((noise @ d @ T_est[-1]).astype(np.float32))
    return np.stack(T_gt), np.stack(T_est), rel


def test_pose_graph_reduces_loop_error(rng):
    T_gt, T_est, rel = chain_problem(rng)
    n = len(T_gt)
    e_i = np.arange(1, n, dtype=np.int32)
    e_j = np.arange(0, n - 1, dtype=np.int32)
    # odometry measurements = estimated relatives (consistent with chain)
    meas = np.stack([T_est[i] @ np.linalg.inv(T_est[j]) for i, j in zip(e_i, e_j)])
    # loop edge: last-to-first with TRUE relative
    loop_meas = T_gt[-1] @ np.linalg.inv(T_gt[0])
    e_i = np.concatenate([e_i, [n - 1]])
    e_j = np.concatenate([e_j, [0]])
    meas = np.concatenate([meas, loop_meas[None]])
    w = np.ones(len(e_i), np.float32)
    w[-1] = 10.0

    pg = pose_graph.PoseGraph(
        T=jnp.asarray(T_est),
        node_valid=jnp.ones(n, bool),
        node_fixed=jnp.zeros(n, bool).at[0].set(True),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_meas=jnp.asarray(meas), e_w=jnp.asarray(w),
    )
    err_before = float(pose_graph.total_error(pg))
    out = pose_graph.optimize(pg, iters=15)
    err_after = float(pose_graph.total_error(out))
    assert err_after < err_before * 0.2

    # end-pose error vs ground truth should shrink markedly
    def end_err(T):
        d = np.linalg.inv(np.asarray(T)[-1]) @ T_gt[-1]
        return np.linalg.norm(d[:3, 3])
    assert end_err(out.T) < end_err(T_est) * 0.5
    # gauge respected
    np.testing.assert_allclose(np.asarray(out.T[0]), T_est[0], atol=1e-5)


def test_pose_graph_zero_residual_is_fixed_point(rng):
    T_gt, _, _ = chain_problem(rng, drift=0.0)
    n = len(T_gt)
    e_i = np.arange(1, n, dtype=np.int32)
    e_j = np.arange(0, n - 1, dtype=np.int32)
    meas = np.stack([T_gt[i] @ np.linalg.inv(T_gt[j]) for i, j in zip(e_i, e_j)])
    pg = pose_graph.PoseGraph(
        T=jnp.asarray(T_gt), node_valid=jnp.ones(n, bool),
        node_fixed=jnp.zeros(n, bool).at[0].set(True),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_meas=jnp.asarray(meas), e_w=jnp.ones(n - 1),
    )
    out = pose_graph.optimize(pg, iters=5)
    np.testing.assert_allclose(np.asarray(out.T), T_gt, atol=1e-4)


def test_analytic_jacobians_match_autodiff(rng):
    """At moderate residuals (where autodiff through the matrix log is
    clean), the analytic Jacobians must agree to first order."""
    import jax
    from aslam.utils.se3 import se3_exp

    T_i = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))
    T_j = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))
    M = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))

    def r_of(xi_i, xi_j):
        return pose_graph.edge_residual(
            se3_exp(xi_i) @ jnp.asarray(T_i), se3_exp(xi_j) @ jnp.asarray(T_j),
            jnp.asarray(M))

    z = jnp.zeros(6)
    Ji_auto = np.asarray(jax.jacfwd(r_of, argnums=0)(z, z))
    Jj_auto = np.asarray(jax.jacfwd(r_of, argnums=1)(z, z))
    Ji, Jj = pose_graph._edge_jacobians(
        jnp.asarray(T_i), jnp.asarray(T_j), jnp.asarray(M))
    # first-order BCH truncation: allow a few-percent deviation
    assert np.abs(np.asarray(Ji) - Ji_auto).max() < 0.15
    assert np.abs(np.asarray(Jj) - Jj_auto).max() < 0.15


def test_cg_matches_dense(rng):
    """Matrix-free PCG pose-graph solver agrees with the dense solver."""
    T_gt, T_est, rel = chain_problem(rng)
    n = len(T_gt)
    e_i = np.arange(1, n, dtype=np.int32)
    e_j = np.arange(0, n - 1, dtype=np.int32)
    meas = np.stack([T_est[i] @ np.linalg.inv(T_est[j]) for i, j in zip(e_i, e_j)])
    loop_meas = T_gt[-1] @ np.linalg.inv(T_gt[0])
    e_i = np.concatenate([e_i, [n - 1]])
    e_j = np.concatenate([e_j, [0]])
    meas = np.concatenate([meas, loop_meas[None]])
    w = np.ones(len(e_i), np.float32)
    w[-1] = 10.0
    pg = pose_graph.PoseGraph(
        T=jnp.asarray(T_est), node_valid=jnp.ones(n, bool),
        node_fixed=jnp.zeros(n, bool).at[0].set(True),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_meas=jnp.asarray(meas), e_w=jnp.asarray(w),
    )
    dense = pose_graph.optimize(pg, iters=15)
    cg = pose_graph.optimize_cg(pg, iters=15, cg_iters=100)
    err_dense = float(pose_graph.total_error(dense))
    err_cg = float(pose_graph.total_error(cg))
    assert err_cg < float(pose_graph.total_error(pg)) * 0.2
    assert err_cg < err_dense * 1.5 + 1e-5
    np.testing.assert_allclose(np.asarray(cg.T), np.asarray(dense.T),
                               atol=5e-3)


def test_cg_scales_to_large_graphs(rng):
    """2048-node ring: dense would materialize a [12288,12288] system;
    CG runs in seconds and closes the loop."""
    n = 2048
    # ring of poses stepping in x with drift, loop edge ties end to start
    step = np.eye(4, dtype=np.float32); step[0, 3] = 0.1
    T_est = [np.eye(4, dtype=np.float32)]
    for i in range(n - 1):
        noise = np.asarray(se3.se3_exp(jnp.asarray(
            rng.normal(0, 0.003, 6).astype(np.float32))))
        T_est.append((noise @ step @ T_est[-1]).astype(np.float32))
    T_est = np.stack(T_est)
    e_i = np.arange(1, n, dtype=np.int32)
    e_j = np.arange(0, n - 1, dtype=np.int32)
    meas = np.einsum("kij,kjl->kil", T_est[1:], np.linalg.inv(T_est[:-1]).astype(np.float32))
    # loop edge: truth = pure steps, end pose = step^(n-1)
    T_true_end = np.eye(4, dtype=np.float32); T_true_end[0, 3] = 0.1 * (n - 1)
    e_i = np.concatenate([e_i, [n - 1]])
    e_j = np.concatenate([e_j, [0]])
    meas = np.concatenate([meas, T_true_end[None]])
    w = np.ones(len(e_i), np.float32); w[-1] = 100.0
    pg = pose_graph.PoseGraph(
        T=jnp.asarray(T_est), node_valid=jnp.ones(n, bool),
        node_fixed=jnp.zeros(n, bool).at[0].set(True),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_meas=jnp.asarray(meas), e_w=jnp.asarray(w),
    )
    out = pose_graph.optimize_cg(pg, iters=8, cg_iters=128)
    before = float(pose_graph.total_error(pg))
    after = float(pose_graph.total_error(out))
    assert after < before * 0.5, (before, after)
    # end node pulled toward the loop constraint
    d_before = np.linalg.norm(T_est[-1][:3, 3] - T_true_end[:3, 3])
    d_after = np.linalg.norm(np.asarray(out.T[-1])[:3, 3] - T_true_end[:3, 3])
    assert d_after < d_before * 0.5
