"""BoW vocabulary: training, transform, scoring, query filters."""

import jax.numpy as jnp
import numpy as np

from aslam.ops import bow


def random_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def corrupt(rng, desc, nbits):
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(nbits):
            w = rng.integers(0, 8); b = rng.integers(0, 32)
            out[i, w] ^= np.uint32(1) << np.uint32(b)
    return out


def test_train_and_transform_shapes(rng):
    descs = random_desc(rng, 500)
    v = bow.train_vocabulary(descs, branching=4, depth=2)
    assert v.n_words == 16
    words = np.asarray(bow.transform(v, jnp.asarray(descs[:50])))
    assert words.shape == (50,)
    assert (words >= 0).all() and (words < 16).all()
    # training descriptors spread over many words
    all_words = np.asarray(bow.transform(v, jnp.asarray(descs)))
    assert len(np.unique(all_words)) > 8


def test_transform_stable_under_small_corruption(rng):
    """Slightly corrupted descriptors usually map to the same word."""
    descs = random_desc(rng, 800)
    v = bow.train_vocabulary(descs, branching=4, depth=2)
    sub = descs[:100]
    w1 = np.asarray(bow.transform(v, jnp.asarray(sub)))
    w2 = np.asarray(bow.transform(v, jnp.asarray(corrupt(rng, sub, 4))))
    assert (w1 == w2).mean() > 0.7


def test_bow_vector_normalized(rng):
    descs = random_desc(rng, 300)
    v = bow.train_vocabulary(descs, branching=4, depth=2)
    words = bow.transform(v, jnp.asarray(descs[:64]))
    vec = np.asarray(bow.bow_vector(v, words, jnp.ones(64, bool)))
    assert np.isclose(np.abs(vec).sum(), 1.0, atol=1e-5)


def test_l1_score_self_is_one(rng):
    descs = random_desc(rng, 300)
    v = bow.train_vocabulary(descs, branching=4, depth=2)
    words = bow.transform(v, jnp.asarray(descs[:64]))
    vec = bow.bow_vector(v, words, jnp.ones(64, bool))
    s = np.asarray(bow.l1_scores(vec, vec[None]))
    assert np.isclose(s[0], 1.0, atol=1e-5)


def test_similar_scenes_score_higher(rng):
    """A frame sharing most descriptors scores higher than a disjoint one."""
    pool = random_desc(rng, 1000)
    v = bow.train_vocabulary(pool, branching=10, depth=2)
    a = pool[:200]
    b = np.concatenate([pool[:150], random_desc(rng, 50)])   # 75% overlap
    c = random_desc(rng, 200)                                # unrelated
    vecs = []
    for d in (a, b, c):
        w = bow.transform(v, jnp.asarray(d))
        vecs.append(bow.bow_vector(v, w, jnp.ones(len(d), bool)))
    s_ab = float(np.asarray(bow.l1_scores(vecs[0], vecs[1][None]))[0])
    s_ac = float(np.asarray(bow.l1_scores(vecs[0], vecs[2][None]))[0])
    assert s_ab > s_ac + 0.2, (s_ab, s_ac)


def test_shared_word_counts(rng):
    pool = random_desc(rng, 400)
    v = bow.train_vocabulary(pool, branching=4, depth=2)
    words_q = bow.transform(v, jnp.asarray(pool[:64]))
    W = v.n_words
    hist = np.zeros((2, W), bool)
    wq = np.asarray(words_q)
    hist[0, np.unique(wq)] = True            # same words
    hist[1, :] = False                       # no words
    out = np.asarray(bow.shared_word_counts(
        words_q, jnp.ones(64, bool), jnp.asarray(hist)))
    assert out[0] == len(np.unique(wq))
    assert out[1] == 0


def test_vocabulary_save_load(tmp_path, rng):
    descs = random_desc(rng, 400)
    v = bow.train_vocabulary(descs, branching=4, depth=2)
    path = str(tmp_path / "vocab.npz")
    bow.save_vocabulary(path, v)
    v2 = bow.load_vocabulary(path)
    assert v2.branching == v.branching and v2.depth == v.depth
    w1 = np.asarray(bow.transform(v, jnp.asarray(descs[:64])))
    w2 = np.asarray(bow.transform(v2, jnp.asarray(descs[:64])))
    np.testing.assert_array_equal(w1, w2)
