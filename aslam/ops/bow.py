"""Binary bag-of-words place recognition: vocabulary training, batched tree
descent, tf-idf scoring, inverted-file-equivalent queries.

Replaces DBoW3 (reference dependency: vocabulary transform frame.cpp:183-189,
similarity score + inverted file keyframedatabase.cpp:48-147).  The
reference *loads* a ~100 MB pretrained vocabulary that is absent from its
repo (main.cpp:67, SURVEY.md §7.3 item 6); here the vocabulary is trained
in-repo by hierarchical binary k-medians over descriptors.

Batched design: the k-ary tree is a dense array [n_nodes, branch, 8]
of packed centroids; `transform` descends all descriptors in parallel
(vmapped argmin-Hamming per level).  KF BoW vectors live in a dense
[K, n_words] matrix, so a database query is one batched L1-score against
every keyframe — the inverted file becomes a matmul-shaped scan, and the
covisibility-group score accumulation (keyframedatabase.cpp:102-146) is a
sparse-adjacency matvec.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    """Complete k-ary tree of binary centroids, depth D, branching B.

    level_cents[l]: [B^l, B, 8] uint32 — children centroids per node.
    Stored as a tuple of arrays (ragged across levels, static shapes).
    idf: [B^D] float32 inverse-document-frequency weights.
    """

    level_cents: tuple
    idf: jnp.ndarray

    @property
    def branching(self) -> int:
        return self.level_cents[0].shape[1]

    @property
    def depth(self) -> int:
        return len(self.level_cents)

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,8] x [M,8] -> [N,M] popcount distances (host, numpy)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit -> one packed centroid [8]."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)   # [N,256]
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, rng: np.random.Generator,
              iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-medians: returns (centroids [k,8], assignment [N])."""
    n = len(descs)
    if n == 0:
        return rng.integers(0, 2**32, (k, 8), dtype=np.uint32), np.zeros(0, np.int64)
    cents = descs[rng.choice(n, size=min(k, n), replace=False)]
    if len(cents) < k:
        extra = rng.integers(0, 2**32, (k - len(cents), 8), dtype=np.uint32)
        cents = np.concatenate([cents, extra])
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(descs, cents)
        assign = d.argmin(1)
        for c in range(k):
            members = descs[assign == c]
            if len(members) > 0:
                cents[c] = _bit_majority(members)
            else:
                cents[c] = descs[rng.integers(n)]  # reseed empty cluster
    return cents, assign


def train_vocabulary(
    descriptors: np.ndarray, branching: int = 10, depth: int = 3,
    seed: int = 0,
) -> Vocabulary:
    """Hierarchical k-medians over packed descriptors [N,8] uint32."""
    rng = np.random.default_rng(seed)
    levels = []
    # groups of descriptor indices per node at the current level
    groups = [np.arange(len(descriptors))]
    for level in range(depth):
        n_nodes = branching ** level
        cents_level = np.empty((n_nodes, branching, 8), np.uint32)
        next_groups = []
        for node in range(n_nodes):
            idx = groups[node] if node < len(groups) else np.zeros(0, np.int64)
            cents, assign = _kmedians(descriptors[idx], branching, rng)
            cents_level[node] = cents
            for c in range(branching):
                next_groups.append(idx[assign == c] if len(idx) else idx)
        groups = next_groups
        levels.append(jnp.asarray(cents_level))

    # idf from training leaf occupancy
    n_words = branching ** depth
    counts = np.array([len(g) for g in groups], np.float64)
    n_docs = max(len(descriptors), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(level_cents=tuple(levels), idf=jnp.asarray(idf))


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    """Persist the trained vocabulary (the reference ships a ~100 MB DBoW3
    .yml.gz artifact; ours is a small npz)."""
    arrays = {f"level_{i}": np.asarray(c) for i, c in enumerate(vocab.level_cents)}
    arrays["idf"] = np.asarray(vocab.idf)
    np.savez_compressed(path, **arrays)


def load_vocabulary(path: str) -> Vocabulary:
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    levels = []
    i = 0
    while f"level_{i}" in data:
        levels.append(jnp.asarray(data[f"level_{i}"]))
        i += 1
    return Vocabulary(level_cents=tuple(levels), idf=jnp.asarray(data["idf"]))


# ----------------------------------------------------------------- device ops

def _ham_rows(desc: jnp.ndarray, cents: jnp.ndarray) -> jnp.ndarray:
    """[8] vs [B,8] -> [B] popcount distances."""
    x = jax.lax.population_count(desc[None, :] ^ cents)
    return jnp.sum(x, axis=-1)


@functools.partial(jax.jit, static_argnames=())
def transform(vocab: Vocabulary, desc: jnp.ndarray) -> jnp.ndarray:
    """Descend all descriptors through the tree: [M,8] -> word ids [M]."""
    B = vocab.branching

    def descend(d):
        node = jnp.int32(0)
        for cents_l in vocab.level_cents:
            dist = _ham_rows(d, cents_l[node])
            node = node * B + jnp.argmin(dist).astype(jnp.int32)
        return node

    return jax.vmap(descend)(desc)


@jax.jit
def bow_vector(vocab: Vocabulary, words: jnp.ndarray,
               valid: jnp.ndarray) -> jnp.ndarray:
    """tf-idf, L1-normalized BoW vector [n_words] from word ids [M]."""
    W = vocab.idf.shape[0]
    tgt = jnp.where(valid, words, W)
    tf = jnp.zeros((W + 1,)).at[tgt].add(1.0)[:W]
    v = tf * vocab.idf
    return v / jnp.maximum(jnp.sum(jnp.abs(v)), 1e-9)


@jax.jit
def l1_scores(query: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """DBoW3 L1 similarity: s = 1 - 0.5 |v1 - v2|_1 for L1-normalized
    vectors.  query [W] vs db [K,W] -> [K]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(query[None, :] - db), axis=-1)


@jax.jit
def shared_word_counts(query_words: jnp.ndarray, query_valid: jnp.ndarray,
                       db_hist: jnp.ndarray) -> jnp.ndarray:
    """Number of distinct shared words between a query (word ids [M]) and
    each database row of word-presence [K,W] — the inverted-file
    common-word filter (keyframedatabase.cpp:50-73)."""
    W = db_hist.shape[1]
    tgt = jnp.where(query_valid, query_words, W)
    present = jnp.zeros((W + 1,), jnp.bfloat16).at[tgt].set(1.0)[:W]
    return jnp.dot(db_hist.astype(jnp.bfloat16), present,
                   preferred_element_type=jnp.float32)
