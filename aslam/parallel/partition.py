"""Covisibility-aware keyframe placement for distributed BA.

SURVEY.md §7.3 item 8: multi-host BA needs covisibility-connected
keyframes on the same device so cross-shard edges (psum payload over
the device interconnect) stay rare.  The sharded BA paths (parallel/sharded_global_ba.py,
parallel/sharded_gn_cg.py) shard KF rows by contiguous array ranges —
right for corridor trajectories, wrong for revisit-heavy maps where
temporally distant KFs are strongly covisible (loops, multi-sequence
sessions).

This module provides the *general* placement: a greedy graph-growing
partitioner (Karypis-style GGGP seed-and-grow, host-side numpy — placement
is an O(K²) one-off decision per BA epoch, not device work) that computes a
row permutation grouping each device's KFs contiguously.  Because every
sharded solver reduces over ALL cross-device coupling with the same psum,
a row permutation changes no math — only how much of the coupling mass is
intra-shard.  `partitioned_global_ba` wraps the existing solver:
permute rows -> solve -> inverse-permute.

Landmark arrays are untouched: lm_first_kf stores insertion ids
(mapstate.py), not row indices, so KF-row permutations are free.
"""

from __future__ import annotations

import numpy as np

from aslam.models.mapstate import MapState, covisibility


def covisibility_weights(m: MapState) -> np.ndarray:
    """[K,K] float64 shared-landmark counts on host (one device matmul)."""
    return np.asarray(covisibility(m), dtype=np.float64)


def partition_keyframes(
    W: np.ndarray, kf_valid: np.ndarray, n_shards: int
) -> np.ndarray:
    """Greedy graph-growing partition of K keyframe rows into n_shards
    equal blocks.  Returns perm [K] int32 with new row i = old row perm[i];
    rows [s*K/n, (s+1)*K/n) of the permuted map belong to shard s.

    Algorithm (GGGP): per shard, seed with the unassigned valid KF of
    maximum remaining degree, then repeatedly absorb the unassigned KF with
    the strongest connection to the shard until the shard reaches capacity.
    Invalid (tombstoned/padding) rows carry no edges and backfill evenly.
    """
    K = W.shape[0]
    if K % n_shards:
        raise ValueError(f"K={K} not divisible by n_shards={n_shards}")
    cap = K // n_shards
    valid = np.asarray(kf_valid, bool)
    W = np.where(valid[:, None] & valid[None, :], W, 0.0)

    unassigned = valid.copy()
    shards: list[list[int]] = []
    degree = W.sum(axis=1)
    for _ in range(n_shards):
        members: list[int] = []
        conn = np.zeros(K)  # connection strength to current shard
        while len(members) < cap and unassigned.any():
            cand = np.where(unassigned, conn, -1.0)
            best = int(np.argmax(cand))
            if cand[best] <= 0.0:
                # no connected candidate: reseed at max remaining degree
                best = int(np.argmax(np.where(unassigned, degree, -1.0)))
            members.append(best)
            unassigned[best] = False
            conn += W[:, best]
        shards.append(members)

    # backfill invalid rows round-robin into shards with free capacity
    spare = [i for i in range(K) if not valid[i]]
    it = iter(spare)
    for members in shards:
        while len(members) < cap:
            members.append(next(it))
    perm = np.concatenate([np.asarray(s, np.int64) for s in shards])
    assert len(np.unique(perm)) == K
    return perm.astype(np.int32)


def contiguous_assignment(K: int, n_shards: int) -> np.ndarray:
    """[K] shard id under the default contiguous-range placement."""
    return (np.arange(K) * n_shards) // K


def edge_cut_fraction(W: np.ndarray, shard_of: np.ndarray) -> float:
    """Fraction of covisibility mass crossing shard boundaries (0 = all
    coupling stays on-device; the quantity psum traffic scales with)."""
    total = W.sum()
    if total == 0:
        return 0.0
    cross = W * (shard_of[:, None] != shard_of[None, :])
    return float(cross.sum() / total)


def shard_of_from_perm(perm: np.ndarray, n_shards: int) -> np.ndarray:
    """[K] shard id per OLD row index implied by a row permutation."""
    K = len(perm)
    shard = np.empty(K, np.int64)
    shard[perm] = contiguous_assignment(K, n_shards)
    return shard


_KF_FIELDS = (
    "kf_T_cw", "kf_valid", "kf_id", "kf_xy", "kf_ur", "kf_z",
    "kf_desc", "kf_octave", "kf_kp_valid", "kf_lm",
)


def permute_kf_rows(m: MapState, perm: np.ndarray) -> MapState:
    """Reorder keyframe rows: new row i = old row perm[i]."""
    import jax.numpy as jnp

    idx = jnp.asarray(perm)
    return m._replace(**{f: getattr(m, f)[idx] for f in _KF_FIELDS})


def partitioned_gn_cg_step(m: MapState, cam, cfg, mesh,
                           W: np.ndarray | None = None, **kwargs):
    """sharded_gn_cg_step with covisibility-aware placement (VERDICT r3
    next #7): permute KF rows so each device's contiguous shard is a
    covisibility cluster, run the distributed joint GN-CG step, restore
    the original row order.  Identical results to the unpermuted solve
    up to float reassociation (kf_id rides the permutation, so the gauge
    anchor is the same keyframe).  Pass a precomputed `W` (e.g. from a
    prior epoch) to skip the covisibility matmul."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from aslam.parallel.sharded_global_ba import pad_map_for_mesh
    from aslam.parallel.sharded_gn_cg import sharded_gn_cg_step

    # a session's map is committed to the device that built it; the mesh
    # step can only take arrays that live on (or may move to) its devices
    m = jax.device_put(m, NamedSharding(mesh, PartitionSpec()))
    padded = pad_map_for_mesh(m, mesh)
    n_dev = mesh.devices.size
    if W is None:
        W = covisibility_weights(padded)
    perm = partition_keyframes(W, np.asarray(padded.kf_valid), n_dev)
    out, stats = sharded_gn_cg_step(
        permute_kf_rows(padded, perm), cam, cfg, mesh, **kwargs
    )
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    restored = permute_kf_rows(out, inv)
    K0 = m.kf_T_cw.shape[0]
    L0 = m.lm_pos.shape[0]
    return m._replace(
        kf_T_cw=restored.kf_T_cw[:K0], lm_pos=restored.lm_pos[:L0]
    ), stats


def partitioned_global_ba(m: MapState, cam, cfg, mesh, **kwargs):
    """sharded_global_ba with covisibility-aware placement.

    Permutes KF rows so each device's contiguous shard is a covisibility
    cluster, runs the distributed solver, and restores the original row
    order.  Identical results to the unpermuted solve (the psum couples all
    shards); only the cross-device share of the coupling changes.
    """
    from aslam.parallel.sharded_global_ba import (
        pad_map_for_mesh, sharded_global_ba,
    )

    padded = pad_map_for_mesh(m, mesh)
    K = padded.kf_T_cw.shape[0]
    n_dev = mesh.devices.size
    W = covisibility_weights(padded)
    perm = partition_keyframes(W, np.asarray(padded.kf_valid), n_dev)
    out, chi2 = sharded_global_ba(
        permute_kf_rows(padded, perm), cam, cfg, mesh, **kwargs
    )
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    restored = permute_kf_rows(out, inv)
    # un-pad back to the caller's capacity
    K0 = m.kf_T_cw.shape[0]
    L0 = m.lm_pos.shape[0]
    return m._replace(
        kf_T_cw=restored.kf_T_cw[:K0], lm_pos=restored.lm_pos[:L0]
    ), chi2
