"""Covisibility-aware keyframe partitioning (general graph placement for
distributed BA, SURVEY.md §7.3 item 8)."""

import jax
import numpy as np
import pytest

from aslam.parallel import partition as pt


def interleaved_clusters(K=32, n_clusters=4, w_in=20.0, w_out=0.0, seed=0):
    """Covisibility where cluster membership is i % n_clusters — the worst
    case for contiguous-range placement (every adjacent row pair crosses)."""
    rng = np.random.default_rng(seed)
    cluster = np.arange(K) % n_clusters
    W = np.where(cluster[:, None] == cluster[None, :], w_in, w_out)
    W += rng.uniform(0, 0.1, (K, K))
    W = (W + W.T) / 2
    np.fill_diagonal(W, 0.0)
    return W, cluster


def test_partition_beats_contiguous_on_interleaved():
    W, _ = interleaved_clusters()
    valid = np.ones(32, bool)
    perm = pt.partition_keyframes(W, valid, 4)
    assert sorted(perm) == list(range(32))
    cut = pt.edge_cut_fraction(W, pt.shard_of_from_perm(perm, 4))
    cut_contig = pt.edge_cut_fraction(W, pt.contiguous_assignment(32, 4))
    assert cut_contig > 0.7          # interleaving wrecks contiguous ranges
    assert cut < 0.05, cut           # partitioner recovers the clusters


def test_partition_contiguous_is_optimal_for_corridor():
    """Banded (corridor) covisibility: the partitioner must not do worse
    than contiguous placement."""
    K = 24
    W = np.zeros((K, K))
    for d in (1, 2, 3):
        idx = np.arange(K - d)
        W[idx, idx + d] = W[idx + d, idx] = 10.0 / d
    perm = pt.partition_keyframes(W, np.ones(K, bool), 4)
    cut = pt.edge_cut_fraction(W, pt.shard_of_from_perm(perm, 4))
    cut_contig = pt.edge_cut_fraction(W, pt.contiguous_assignment(K, 4))
    assert cut <= cut_contig + 1e-9


def test_partition_backfills_invalid_rows():
    K = 16
    valid = np.zeros(K, bool)
    valid[:10] = True
    W = np.zeros((K, K))
    W[:10, :10] = 5.0
    np.fill_diagonal(W, 0.0)
    perm = pt.partition_keyframes(W, valid, 4)
    assert sorted(perm) == list(range(K))
    # every shard has exactly 4 rows; invalid rows spread across shards
    shard = pt.shard_of_from_perm(perm, 4)
    for s in range(4):
        assert (shard == s).sum() == 4


def test_partitioned_global_ba_matches_unpartitioned(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from aslam.parallel import mesh as mesh_mod
    from aslam.parallel import sharded_global_ba as sgba
    from tests.test_global_ba import build_noisy_map

    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(
        rng, n_kfs=8, n_pts=128)
    mesh = mesh_mod.make_mesh(8, dp=4, lm=2)

    padded = sgba.pad_map_for_mesh(m, mesh)
    ref, _ = sgba.sharded_global_ba(padded, cfg.camera, cfg.ba, mesh,
                                    iters=4, robust_iters=2)
    out, _ = pt.partitioned_global_ba(m, cfg.camera, cfg.ba, mesh,
                                      iters=4, robust_iters=2)
    np.testing.assert_allclose(
        np.asarray(out.kf_T_cw)[:n_kfs], np.asarray(ref.kf_T_cw)[:n_kfs],
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(out.lm_pos)[:n_pts], np.asarray(ref.lm_pos)[:n_pts],
        atol=2e-3,
    )


def test_permute_kf_rows_roundtrip(rng):
    from tests.test_global_ba import build_noisy_map

    cfg, m, *_ = build_noisy_map(rng, n_kfs=6, n_pts=64)
    K = m.kf_T_cw.shape[0]
    perm = np.random.default_rng(0).permutation(K).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(K, dtype=np.int32)
    m2 = pt.permute_kf_rows(pt.permute_kf_rows(m, perm), inv)
    for f in pt._KF_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(m, f)), np.asarray(getattr(m2, f)), err_msg=f)


def test_partitioned_gn_cg_matches_unpartitioned(rng):
    """VERDICT r4 #7: the GGGP permutation wired into the joint GN-CG
    solver must not change the result (the psum couples all shards; a
    row permutation only moves coupling mass intra-shard)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from aslam.parallel import mesh as mesh_mod
    from aslam.parallel import sharded_global_ba as sgba
    from aslam.parallel.sharded_gn_cg import sharded_gn_cg_step
    from tests.test_global_ba import build_noisy_map

    cfg, m, T_true, pts_true, n_kfs, n_pts = build_noisy_map(
        rng, n_kfs=8, n_pts=128)
    mesh = mesh_mod.make_mesh(8, dp=4, lm=2)

    padded = sgba.pad_map_for_mesh(m, mesh)
    ref, ref_stats = sharded_gn_cg_step(padded, cfg.camera, cfg.ba, mesh,
                                        cg_iters=8)
    out, stats = pt.partitioned_gn_cg_step(m, cfg.camera, cfg.ba, mesh,
                                           cg_iters=8)
    np.testing.assert_allclose(
        np.asarray(out.kf_T_cw)[:n_kfs], np.asarray(ref.kf_T_cw)[:n_kfs],
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(out.lm_pos)[:n_pts], np.asarray(ref.lm_pos)[:n_pts],
        atol=2e-3,
    )
    np.testing.assert_allclose(float(stats.chi2), float(ref_stats.chi2),
                               rtol=0.05)
