"""DBSCAN keypoint declustering as a batched label-propagation kernel.

Replaces `Core/dbscan.{h,cpp}` (reference component 10: O(N^2) pairwise
distances, eps=10 px, minPts=2, keeps `featuresFromCluster` strongest per
cluster and discards the rest; a feature-experiment utility not wired into
the main pipeline, dbscan.cpp:74-114).

Batched formulation: the O(N^2) distance matrix is one fused op; cluster
labels converge by iterated min-label propagation over the core-point
adjacency (log-diameter iterations), and the per-cluster strongest-k
selection is a rank-within-group computed by sorting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("eps", "min_pts", "max_iters"))
def dbscan_labels(
    xy: jnp.ndarray,       # [N,2] keypoint coords
    valid: jnp.ndarray,    # [N] bool
    eps: float = 10.0,
    min_pts: int = 2,
    max_iters: int = 16,
) -> jnp.ndarray:
    """Cluster labels [N] int32: connected components of the eps-graph
    restricted to core points (border points join their nearest core's
    cluster); -1 = noise/invalid."""
    N = xy.shape[0]
    d2 = jnp.sum((xy[:, None, :] - xy[None, :, :]) ** 2, -1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    degree = jnp.sum(adj, axis=1)                    # includes self
    core = valid & (degree >= min_pts + 1)

    # labels propagate only through core points
    core_adj = adj & core[None, :]

    labels = jnp.where(valid, jnp.arange(N, dtype=jnp.int32), N)

    def body(_, lab):
        # each point takes the min label among its core neighbors & itself
        neigh = jnp.where(core_adj, lab[None, :], N)
        best = jnp.min(neigh, axis=1)
        new = jnp.minimum(lab, best)
        # only core points pass labels on; border points receive but their
        # own label is not propagated (handled by core_adj masking)
        return jnp.where(valid, new, N)

    labels = jax.lax.fori_loop(0, max_iters, body, labels)
    has_core_neighbor = jnp.any(core_adj, axis=1)
    return jnp.where(valid & (core | has_core_neighbor), labels, -1)


@functools.partial(
    jax.jit, static_argnames=("eps", "min_pts", "keep_per_cluster")
)
def decluster(
    xy: jnp.ndarray,
    response: jnp.ndarray,
    valid: jnp.ndarray,
    eps: float = 10.0,
    min_pts: int = 2,
    keep_per_cluster: int = 1,
) -> jnp.ndarray:
    """Keep only the `keep_per_cluster` strongest keypoints of each dense
    cluster (dbscan.cpp:74-114 semantics); noise points always survive.
    Returns the surviving mask [N]."""
    N = xy.shape[0]
    labels = dbscan_labels(xy, valid, eps, min_pts)
    in_cluster = labels >= 0
    # rank within cluster by response: sort by (label, -response)
    key = jnp.where(in_cluster, labels.astype(jnp.float32), N) * 1e6 \
        - jnp.where(valid, response, -1.0)
    order = jnp.argsort(key)
    sorted_labels = labels[order]
    idx = jnp.arange(N)
    group_start = jnp.searchsorted(sorted_labels, sorted_labels, side="left")
    rank_sorted = idx - group_start
    rank = jnp.zeros((N,), jnp.int32).at[order].set(rank_sorted)
    return valid & (~in_cluster | (rank < keep_per_cluster))
