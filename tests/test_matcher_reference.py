"""The plain matcher (masked_distance_matrix + _top2 + knn_ratio_match)
against a NumPy popcount reference, up to the full 1024x1024 width."""

import jax.numpy as jnp
import numpy as np
import pytest

from aslam.ops import matching
from aslam.ops.hamming import INVALID_DIST, masked_distance_matrix

RATIO, MAX_DIST = 0.9, 100.0


def popcount_distances(a, b):
    bits_a = np.unpackbits(a.view(np.uint8), axis=1).astype(np.int64)
    bits_b = np.unpackbits(b.view(np.uint8), axis=1).astype(np.int64)
    return bits_a @ (1 - bits_b).T + (1 - bits_a) @ bits_b.T


def reference(dq, vq, dt, vt):
    d = np.where(vq[:, None] & vt[None, :], popcount_distances(dq, dt),
                 INVALID_DIST).astype(np.float64)
    order = np.argsort(d, axis=1, kind="stable")   # ties -> lowest index
    rows = np.arange(len(d))
    i1, i2 = order[:, 0], order[:, 1]
    d1, d2 = d[rows, i1], d[rows, i2]
    ok = vq & (d1 <= MAX_DIST) & (d1 < RATIO * d2) & (d1 < INVALID_DIST)
    return d, i1, i2, np.where(ok, i1, -1), ok


def make_case(case, nq, nt, seed):
    rng = np.random.default_rng(seed)
    dt = rng.integers(0, 2**32, (nt, 8), dtype=np.uint32)
    # queries: noisy copies of targets (flip ~10 bits) so real matches exist
    src = rng.integers(0, nt, nq)
    flips = rng.random((nq, 8, 32)) < 10 / 256
    noise = np.packbits(flips, axis=-1, bitorder="little").view("<u4")[..., 0]
    dq = dt[src] ^ noise.astype(np.uint32)
    vq = rng.random(nq) < 0.95
    vt = np.ones(nt, bool)
    if case == "ties":
        # every target twice: d1 == d2 at two indices for every query
        dt[nt // 2:] = dt[:nt - nt // 2]
    elif case == "invalid_targets":
        vt[:] = False
    return dq, vq, dt, vt


@pytest.mark.parametrize("nq,nt", [(1, 2), (7, 33), (128, 256),
                                   (500, 1000), (1024, 1024)])
@pytest.mark.parametrize("case", ["random", "ties", "invalid_targets"])
def test_matcher_matches_popcount_reference(case, nq, nt):
    dq, vq, dt, vt = make_case(case, nq, nt, seed=nq + nt)
    d_ref, i1_ref, i2_ref, idx_ref, ok_ref = reference(dq, vq, dt, vt)
    args = tuple(map(jnp.asarray, (dq, vq, dt, vt)))
    d = np.asarray(masked_distance_matrix(*args))
    np.testing.assert_array_equal(d, d_ref)
    d1, i1, d2, i2 = map(np.asarray, matching._top2(jnp.asarray(d)))
    rows = np.arange(nq)
    np.testing.assert_array_equal(d1, d_ref[rows, i1_ref])
    np.testing.assert_array_equal(d2, d_ref[rows, i2_ref])
    np.testing.assert_array_equal(i1, i1_ref)
    if case != "invalid_targets":      # all-INVALID rows: any order is ok
        np.testing.assert_array_equal(i2, i2_ref)
    m = matching.knn_ratio_match(*args, ratio=RATIO, max_dist=MAX_DIST)
    np.testing.assert_array_equal(np.asarray(m.valid), ok_ref)
    np.testing.assert_array_equal(np.asarray(m.target_idx), idx_ref)
    if case == "ties":
        assert not ok_ref.any()        # the ratio test rejects exact ties
    if case == "invalid_targets":
        assert not ok_ref.any() and (np.asarray(m.distance) == INVALID_DIST).all()
