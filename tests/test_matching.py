import jax.numpy as jnp
import numpy as np

from aslam.ops import matching


def random_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def corrupt(rng, desc, nbits):
    """Flip nbits random bits in each descriptor."""
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(nbits):
            w = rng.integers(0, 8)
            b = rng.integers(0, 32)
            out[i, w] ^= np.uint32(1) << np.uint32(b)
    return out


def test_knn_ratio_match_exact(rng):
    d1 = random_desc(rng, 32)
    perm = rng.permutation(32)
    d2 = d1[perm]
    m = matching.knn_ratio_match(
        jnp.asarray(d1), jnp.ones(32, bool), jnp.asarray(d2), jnp.ones(32, bool),
        ratio=0.9, max_dist=64,
    )
    idx = np.asarray(m.target_idx)
    v = np.asarray(m.valid)
    # exact duplicates match at distance 0 and pass any ratio
    assert v.all()
    np.testing.assert_array_equal(perm[idx], np.arange(32))


def test_knn_ratio_rejects_ambiguous(rng):
    d1 = random_desc(rng, 8)
    # target contains two near-identical copies -> ratio test must reject
    d2 = np.concatenate([corrupt(rng, d1, 2), corrupt(rng, d1, 2)])
    m = matching.knn_ratio_match(
        jnp.asarray(d1), jnp.ones(8, bool), jnp.asarray(d2), jnp.ones(16, bool),
        ratio=0.7, max_dist=64,
    )
    assert not np.asarray(m.valid).any()


def test_knn_respects_validity(rng):
    d1 = random_desc(rng, 16)
    d2 = d1.copy()
    valid_t = np.ones(16, bool)
    valid_t[5] = False
    m = matching.knn_ratio_match(
        jnp.asarray(d1), jnp.ones(16, bool), jnp.asarray(d2), jnp.asarray(valid_t),
        ratio=0.9, max_dist=64,
    )
    assert not bool(np.asarray(m.valid)[5])  # its perfect twin is masked


def test_resolve_duplicates(rng):
    m = matching.Matches(
        target_idx=jnp.asarray([3, 3, 5, -1]),
        distance=jnp.asarray([10.0, 4.0, 7.0, 1.0]),
        valid=jnp.asarray([True, True, True, False]),
    )
    out = matching.resolve_duplicates(m, 8)
    idx = np.asarray(out.target_idx)
    assert idx.tolist() == [-1, 3, 5, -1]  # query 1 wins target 3 (dist 4<10)


def test_projection_match_window(rng):
    """Landmark matches the right feature only within its search window."""
    n = 16
    lm_desc = random_desc(rng, 4)
    kp_desc = np.concatenate([lm_desc, random_desc(rng, n - 4)])
    kp_xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    pred_uv = kp_xy[:4] + rng.uniform(-3, 3, (4, 2)).astype(np.float32)
    # landmark 2 predicted far away from its twin
    pred_uv[2] = kp_xy[2] + 100.0
    m = matching.projection_match(
        jnp.asarray(lm_desc), jnp.ones(4, bool), jnp.asarray(pred_uv),
        jnp.asarray(kp_xy), jnp.asarray(kp_desc), jnp.ones(n, bool),
        jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
        radius=8.0, th_high=100.0, ratio=0.8,
    )
    idx = np.asarray(m.target_idx)
    assert idx[0] == 0 and idx[1] == 1 and idx[3] == 3
    assert idx[2] == -1  # out of window


def test_projection_match_th_high(rng):
    lm_desc = random_desc(rng, 2)
    kp_desc = random_desc(rng, 2)  # unrelated: expect dist ~128 > 100
    kp_xy = np.array([[10.0, 10.0], [50.0, 50.0]], np.float32)
    m = matching.projection_match(
        jnp.asarray(lm_desc), jnp.ones(2, bool), jnp.asarray(kp_xy),
        jnp.asarray(kp_xy), jnp.asarray(kp_desc), jnp.ones(2, bool),
        jnp.zeros(2, jnp.int32), jnp.ones(2, bool),
        radius=8.0, th_high=100.0, ratio=0.8,
    )
    assert not np.asarray(m.valid).any()


def test_window_match(rng):
    """Spatially-windowed 2-NN ratio match: twins found only in-window."""
    n = 12
    d1 = random_desc(rng, n)
    d2 = d1.copy()
    uv1 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    uv2 = uv1 + rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv2[4] = uv1[4] + 100.0  # out of window
    m = matching.window_match(
        jnp.asarray(d1), jnp.ones(n, bool), jnp.asarray(uv1),
        jnp.asarray(d2), jnp.ones(n, bool), jnp.asarray(uv2),
        radius=10.0, max_dist=64.0, ratio=0.9,
    )
    idx = np.asarray(m.target_idx)
    assert idx[4] == -1
    good = [i for i in range(n) if i != 4]
    assert (idx[good] == np.asarray(good)).mean() > 0.8
