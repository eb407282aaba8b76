"""Batched 256-bit Hamming distance — the matcher's core primitive.

Replaces the reference's brute-force `cv::BFMatcher::knnMatch` /
`cv::norm(..., NORM_HAMMING)` scalar loops (matcher.cpp:55-88, 355-358).

Two implementations:
  * `distance_matrix_popcount` — XOR + `lax.population_count`, the exact
    definition; used as ground truth in tests and for small queries.
  * `distance_matrix` (default) — the GEMM path: unpack descriptors to ±1
    bfloat16 planes and compute D = (256 - A·Bᵀ)/2 as one matmul.  Each ±1
    dot product over 256 bits is an integer in [-256, 256], exactly
    representable, and accumulation happens in float32 — so this path is
    bit-exact with popcount while running as one bf16 tensor-core GEMM
    (a 1024x1024 match = 0.5 GFLOP).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from aslam.ops.orb import unpack_bits

BITS = 256
INVALID_DIST = 1e6


def signs_from_packed(words: jnp.ndarray) -> jnp.ndarray:
    """uint32 [N,8] -> ±1 bfloat16 [N,256]."""
    bits = unpack_bits(words)
    return (bits.astype(jnp.float32) * 2.0 - 1.0).astype(jnp.bfloat16)


def distance_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Descriptor distances [Na, Nb] float32.

    Packed uint32 descriptors -> Hamming (±1 bf16 planes); float descriptors
    (SIFT/SURF family, ops/desc.py) -> L2, the `Extractor::mNorm` switch of
    the reference (extractor.cpp:36) expressed as dtype dispatch.
    """
    if desc_a.dtype == jnp.uint32:
        sa = signs_from_packed(desc_a)
        sb = signs_from_packed(desc_b)
        dot = jnp.dot(sa, sb.T, preferred_element_type=jnp.float32)
        return (BITS - dot) * 0.5
    return l2_distance_matrix(desc_a, desc_b)


def l2_distance_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Euclidean distances [Na, Nb] float32 for float descriptors.

    |a-b|² = |a|² + |b|² - 2ab with the cross term as an f32 matmul
    (geometry rule: no implicit bf16 for float descriptors)."""
    a = desc_a.astype(jnp.float32)
    b = desc_b.astype(jnp.float32)
    cross = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    sq = (
        jnp.sum(a * a, axis=1)[:, None]
        + jnp.sum(b * b, axis=1)[None, :]
        - 2.0 * cross
    )
    return jnp.sqrt(jnp.maximum(sq, 0.0))


def distance_matrix_popcount(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Exact XOR/popcount Hamming distances [Na, Nb] float32."""
    x = lax.population_count(desc_a[:, None, :] ^ desc_b[None, :, :])
    return jnp.sum(x, axis=-1).astype(jnp.float32)


def masked_distance_matrix(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
) -> jnp.ndarray:
    """Distance matrix with INVALID_DIST where either side is padding."""
    d = distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    return jnp.where(mask, d, INVALID_DIST)
