"""Correspondence search ops: 2-NN ratio matching, guided projection
matching, duplicate resolution.

Replaces the reference Matcher family (matcher.cpp):
  * `KnnMatch` (matcher.cpp:23-88): BFMatcher knn k=2 + ratio test ->
    one masked top-2 over the GEMM-built Hamming distance matrix.
  * `ProjectionMatch` (matcher.cpp:90-145): per-landmark guided search in a
    pixel window with two-best ratio + octave tiebreak, TH_HIGH gate ->
    masked distance matrix + batched top-2 + scatter-min conflict
    resolution (the reference's sequential AddLandmark overwrites become an
    explicit per-feature argmin).
  * `BoWMatch` word-bucketed matching (matcher.cpp:147-210) is expressed as
    the same masked matrix with a word-equality mask (ops/bow.py supplies
    word ids).

All functions are shape-static and jit/vmap friendly; `-1` marks "no match".
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from aslam.ops.hamming import INVALID_DIST, masked_distance_matrix


class Matches(NamedTuple):
    """Fixed-size match set: for each query row, index into the target set."""

    target_idx: jnp.ndarray  # [Q] int32, -1 = unmatched
    distance: jnp.ndarray    # [Q] float32
    valid: jnp.ndarray       # [Q] bool


def _top2(d: jnp.ndarray):
    """Row-wise two smallest distances -> (d1, i1, d2, i2)."""
    neg_vals, idx = lax.top_k(-d, 2)
    return -neg_vals[:, 0], idx[:, 0], -neg_vals[:, 1], idx[:, 1]


def knn_ratio_match(
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    ratio: float,
    max_dist: float = 256.0,
) -> Matches:
    """Lowe-ratio 2-NN matching, query rows -> target columns: one masked
    [Q,T] Hamming distance matrix (a bf16 GEMM) followed by a row top-2."""
    d = masked_distance_matrix(desc_q, valid_q, desc_t, valid_t)
    d1, i1, d2, _ = _top2(d)
    ok = valid_q & (d1 <= max_dist) & (d1 < ratio * d2) & (d1 < INVALID_DIST)
    return Matches(
        target_idx=jnp.where(ok, i1, -1),
        distance=d1,
        valid=ok,
    )


def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance query per claimed target index.

    Array-land replacement for the reference's `set<int> trainIdxs` dedup
    (matcher.cpp:190-204) and last-writer-wins AddLandmark conflicts: a
    scatter-min elects one winner per target feature deterministically.
    """
    q = matches.target_idx.shape[0]
    # composite key keeps ties deterministic: distance then query index
    key = matches.distance * (q + 1) + jnp.arange(q, dtype=jnp.float32)
    tgt = jnp.where(matches.valid, matches.target_idx, n_targets)
    best = jnp.full((n_targets + 1,), jnp.inf, jnp.float32).at[tgt].min(key)
    win = matches.valid & (key <= best[tgt])
    return Matches(
        target_idx=jnp.where(win, matches.target_idx, -1),
        distance=matches.distance,
        valid=win,
    )


def compact_candidates(cand: jnp.ndarray, cap: int):
    """Gather the indices of up to `cap` True entries of `cand` (stable —
    lowest ids first).  Guided matching over a big landmark table is sparse
    (only frustum-visible local-map landmarks participate); compacting
    before the [cand, N] distance matrix bounds per-frame matching cost by
    `cap` instead of the map's landmark capacity (the 0.5 GB/frame cliff at
    config-5 scale).  Returns (idx [cap] int32, valid [cap] bool,
    n_overflow scalar int32 = candidates dropped)."""
    # nonzero-with-static-size = prefix-sum + bounded scatter; the previous
    # full argsort over the landmark table cost ~1 ms at L=64k (r5)
    (idx,) = jnp.nonzero(cand, size=cap, fill_value=cand.shape[0])
    n_cand = jnp.sum(cand.astype(jnp.int32))
    valid = jnp.arange(cap) < n_cand
    idx = jnp.where(valid, idx, 0).astype(jnp.int32)
    n_over = jnp.maximum(n_cand - cap, 0)
    return idx, valid, n_over


def projection_match(
    lm_desc: jnp.ndarray,      # [L,8] uint32 landmark descriptors
    lm_valid: jnp.ndarray,     # [L] bool (in frustum & tracked-in-view)
    pred_uv: jnp.ndarray,      # [L,2] predicted pixel location
    kp_xy: jnp.ndarray,        # [N,2] feature pixel coords
    kp_desc: jnp.ndarray,      # [N,8] uint32
    kp_valid: jnp.ndarray,     # [N] bool
    kp_octave: jnp.ndarray,    # [N] int32
    kp_free: jnp.ndarray,      # [N] bool: not already bound to a landmark
    radius: float,
    th_high: float,
    ratio: float,
) -> Matches:
    """Guided landmark->feature search (matcher.cpp:90-145 semantics):

    For every landmark, search features within a `radius` box around its
    predicted projection; accept the best descriptor distance if
    <= th_high, rejecting when the two best candidates live on the same
    pyramid level and fail the ratio test.  Conflicting claims on one
    feature resolve to the lowest distance.
    """
    L = lm_desc.shape[0]
    N = kp_desc.shape[0]
    dx = pred_uv[:, 0:1] - kp_xy[None, :, 0]
    dy = pred_uv[:, 1:2] - kp_xy[None, :, 1]
    in_window = (jnp.abs(dx) < radius) & (jnp.abs(dy) < radius)

    d = masked_distance_matrix(lm_desc, lm_valid, kp_desc, kp_valid & kp_free)
    d = jnp.where(in_window, d, INVALID_DIST)

    d1, i1, d2, i2 = _top2(d)
    lvl1 = kp_octave[i1]
    lvl2 = kp_octave[i2]
    has2 = d2 < INVALID_DIST
    ratio_reject = has2 & (lvl1 == lvl2) & (d1 > ratio * d2)
    ok = lm_valid & (d1 <= th_high) & ~ratio_reject
    m = Matches(target_idx=jnp.where(ok, i1, -1), distance=d1, valid=ok)
    return resolve_duplicates(m, N)


def window_match(
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    uv_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    uv_t: jnp.ndarray,
    radius: float,
    max_dist: float,
    ratio: float,
) -> Matches:
    """Spatially-windowed 2-NN ratio match (used for stereo/VO-style search
    and loop-candidate verification)."""
    d = masked_distance_matrix(desc_q, valid_q, desc_t, valid_t)
    dx = uv_q[:, 0:1] - uv_t[None, :, 0]
    dy = uv_q[:, 1:2] - uv_t[None, :, 1]
    d = jnp.where((jnp.abs(dx) < radius) & (jnp.abs(dy) < radius), d, INVALID_DIST)
    d1, i1, d2, _ = _top2(d)
    ok = valid_q & (d1 <= max_dist) & (d1 < ratio * d2)
    m = Matches(target_idx=jnp.where(ok, i1, -1), distance=d1, valid=ok)
    return resolve_duplicates(m, desc_t.shape[0])
