"""Oriented-BRIEF descriptors: patch extraction, IC-angle, rBRIEF, packing.

Replaces `ORBextractor::computeOrbDescriptor` + `IC_Angle` (reference
orbextractor.cpp:14-39, 87-344, 748-800).  Key design differences:

  * The sampling pattern is **self-generated** (seeded Gaussian pairs inside
    the radius-15 disc, the construction from the original BRIEF/ORB papers)
    rather than the hardcoded `bit_pattern_31_` table.  Descriptors only ever
    match against descriptors produced by this same engine (the BoW
    vocabulary is also trained in-repo), so there is no OpenCV
    bit-compatibility requirement — only internal consistency.
  * All keypoints are processed as one batch: patch gather via vmapped
    dynamic_slice, angle/descriptor math as dense [K, ...] array ops.
  * Descriptors are bit-packed into uint32 [K, 8] words; the matcher
    unpacks to ±1 bf16 planes for GEMM Hamming matmuls (ops/hamming.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 15
PATCH = 2 * PATCH_RADIUS + 1  # 31
N_BITS = 256


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2) test-pair offsets, all within the
    radius-15 disc so any in-plane rotation stays inside the 31x31 patch."""
    rng = np.random.default_rng(0x0B5E55ED)
    sigma = PATCH / 5.0

    def sample(n):
        pts = np.empty((0, 2), np.float64)
        while len(pts) < n:
            cand = rng.normal(0.0, sigma, (2 * n, 2))
            keep = np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 0.5
            pts = np.concatenate([pts, cand[keep]])
        return np.round(pts[:n]).astype(np.int32)

    p1 = sample(N_BITS)
    p2 = sample(N_BITS)
    # avoid degenerate identical pairs
    same = np.all(p1 == p2, axis=1)
    p2[same, 0] = np.clip(p2[same, 0] + 1, -PATCH_RADIUS + 1, PATCH_RADIUS - 1)
    return np.concatenate([p1, p2], axis=1)


@functools.lru_cache(maxsize=1)
def _circle_masks() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mask, x-weights, y-weights) for the IC-angle circular patch."""
    ys, xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
    mask = (xs * xs + ys * ys) <= PATCH_RADIUS * PATCH_RADIUS
    return (
        mask.astype(np.float32),
        (xs * mask).astype(np.float32),
        (ys * mask).astype(np.float32),
    )


def extract_patches(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Gather 31x31 patches centered at integer keypoint coords.

    img: [H,W] float32; xy: [K,2] float32 (x, y).  Coordinates are clamped so
    patches always fit (callers mask border keypoints as invalid anyway).
    Returns [K, 31, 31].
    """
    H, W = img.shape
    x = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), PATCH_RADIUS, W - PATCH_RADIUS - 1)
    y = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), PATCH_RADIUS, H - PATCH_RADIUS - 1)

    def one(xi, yi):
        return jax.lax.dynamic_slice(
            img, (yi - PATCH_RADIUS, xi - PATCH_RADIUS), (PATCH, PATCH)
        )

    return jax.vmap(one)(x, y)


def ic_angle(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per patch (orbextractor.cpp:14-39).

    patches: [K,31,31] -> angle [K] radians in (-pi, pi].
    """
    _, wx, wy = _circle_masks()
    m10 = jnp.einsum("kij,ij->k", patches, jnp.asarray(wx))
    m01 = jnp.einsum("kij,ij->k", patches, jnp.asarray(wy))
    return jnp.arctan2(m01, m10)


N_ANGLE_BINS = 30  # the original ORB paper's 2*pi/30 rotation quantization


@functools.lru_cache(maxsize=1)
def _binned_delta_rows() -> np.ndarray:
    """[N_ANGLE_BINS * 256, 961] float32 comparison-delta rows.

    Row (b*256 + t) is onehot(p2') - onehot(p1') for test pair t rotated by
    bin angle b, so  patch_flat . row > 0  <=>  I(p1') < I(p2').  This
    turns the 2x256 per-keypoint pixel gathers into one matmul; the
    2*pi/30 quantization is the rBRIEF construction itself (ORB paper
    §4.3; OpenCV precomputes the same per-bin integer patterns)."""
    pat = brief_pattern().astype(np.float64)              # [256,4]
    rows = np.zeros((N_ANGLE_BINS * N_BITS, PATCH * PATCH), np.float32)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        for (px, py, qx, qy), t in zip(pat, range(N_BITS)):
            for sign, x, y in ((-1.0, px, py), (1.0, qx, qy)):
                ix = int(np.clip(np.round(x * ca - y * sa),
                                 -PATCH_RADIUS, PATCH_RADIUS))
                iy = int(np.clip(np.round(x * sa + y * ca),
                                 -PATCH_RADIUS, PATCH_RADIUS))
                rows[b * N_BITS + t,
                     (iy + PATCH_RADIUS) * PATCH + ix + PATCH_RADIUS] += sign
    return rows


def brief_descriptors(patches: jnp.ndarray, angles: jnp.ndarray) -> jnp.ndarray:
    """Rotation-steered BRIEF: [K,31,31] patches + [K] angles -> bits [K,256].

    Per keypoint, the 256 test pairs are rotated by the IC angle quantized
    to 2*pi/30 bins (the ORB paper's construction), and the intensity
    comparison I(p1) < I(p2) produces each bit — evaluated as a single
    [K,961] @ [961, 30*256] comparison-delta matmul plus a per-keypoint
    bin selection (see _binned_delta_rows).
    """
    K = patches.shape[0]
    flat = patches.reshape(K, PATCH * PATCH)
    D = jnp.asarray(_binned_delta_rows())                 # [30*256, 961]
    scores = (flat @ D.T).reshape(K, N_ANGLE_BINS, N_BITS)
    two_pi = 2.0 * jnp.pi
    bin_f = jnp.round(jnp.mod(angles, two_pi) / two_pi * N_ANGLE_BINS)
    bins = jnp.mod(bin_f.astype(jnp.int32), N_ANGLE_BINS)  # [K]
    onehot = (bins[:, None] == jnp.arange(N_ANGLE_BINS)[None, :])
    sel = jnp.sum(scores * onehot[:, :, None], axis=1)     # [K,256]
    return sel > 0


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """Bool [K,256] -> uint32 [K,8] packed words (bit i -> word i//32)."""
    K = bits.shape[0]
    b = bits.reshape(K, 8, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(b * weights[None, None, :], axis=-1, dtype=jnp.uint32)


def unpack_bits(words: jnp.ndarray) -> jnp.ndarray:
    """uint32 [K,8] -> bool [K,256]."""
    K = words.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = (words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return b.reshape(K, 256).astype(jnp.bool_)


def describe(
    img_blurred: jnp.ndarray, xy: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full descriptor path for one pyramid level: -> (desc [K,8] uint32,
    angle [K] float32)."""
    patches = extract_patches(img_blurred, xy)
    angles = ic_angle(patches)
    bits = brief_descriptors(patches, angles)
    return pack_bits(bits), angles
