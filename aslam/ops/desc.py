"""Alternate descriptor families: BRIEF, FREAK-style, LATCH-style (binary)
and a SIFT-style float descriptor.

The reference's Extractor facade offers descriptors {ORB, BRISK, FREAK,
BRIEF, LATCH, SURF, SIFT} (extractor.h:18-25, extractor.cpp:79-134) via
OpenCV, with `Extractor::mNorm` switching the matcher between Hamming and L2
(extractor.cpp:36).  Here each family is a batched, gather-based XLA
computation over the same 31x31 patches as ops/orb.py; binary families pack
to the same uint32 [K,8] layout so the GEMM Hamming matcher is shared, and
the float family matches through the L2 path in ops/hamming.py.

Like the rBRIEF pattern (ops/orb.py), sampling patterns are self-generated
from seeded RNG: descriptors only ever match descriptors from this engine,
so internal consistency — not OpenCV bit-compatibility — is the contract.

All describe_* functions share one signature:
    describe(img_blurred, xy) -> (desc, angle)
with angle = IC angle (radians) used for rotation steering (the reference's
FREAK/LATCH compute their own orientation; we reuse the intensity centroid,
which is the ORB choice — a documented deviation, not a capability gap).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from aslam.ops.orb import (
    N_BITS,
    PATCH,
    PATCH_RADIUS,
    brief_descriptors,
    extract_patches,
    ic_angle,
    pack_bits,
)

SIFT_DIM = 128


# --------------------------------------------------------------------------
# BRIEF: the non-steered original (cv::xfeatures2d::BriefDescriptorExtractor)
# --------------------------------------------------------------------------

def describe_brief(img_blurred: jnp.ndarray, xy: jnp.ndarray):
    """Unrotated BRIEF-256.  Same test pairs as rBRIEF, no steering."""
    patches = extract_patches(img_blurred, xy)
    angles = ic_angle(patches)  # reported for API parity; not applied
    bits = brief_descriptors(patches, jnp.zeros_like(angles))
    return pack_bits(bits), angles


# --------------------------------------------------------------------------
# FREAK-style: retinal sampling pattern (coarse periphery, fine fovea)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _freak_pattern() -> tuple[np.ndarray, np.ndarray]:
    """Retina: 43 receptive fields = center + 7 rings x 6 points, radius and
    smoothing growing with eccentricity (the FREAK paper's layout).

    Returns (points [43, S, 2] float32 sample offsets per field — each field
    is averaged over S=9 samples within its smoothing disc — and
    pairs [256, 2] int32 field-index pairs).
    """
    rng = np.random.default_rng(0xF4EAC0DE)
    fields = [np.zeros((1, 2))]  # field centers; smoothing radii below
    radii = [0.8]
    n_rings = 7
    for r in range(n_rings):
        rho = 1.8 * (1.35 ** r)             # 1.8 .. ~11.1  (< PATCH_RADIUS-2)
        smooth = 0.5 + 0.35 * rho           # grows with eccentricity
        phase = (np.pi / 6.0) * (r % 2)     # stagger alternate rings
        for i in range(6):
            a = phase + i * np.pi / 3.0
            fields.append(np.array([[rho * np.cos(a), rho * np.sin(a)]]))
            radii.append(smooth)
    centers = np.concatenate(fields, axis=0)            # [43,2]
    # 9 fixed sub-samples per field: center + 8-point ring at the smoothing
    # radius — a box approximation of the per-field Gaussian window
    ring = np.stack(
        [np.zeros(2)]
        + [
            np.array([np.cos(a), np.sin(a)])
            for a in np.linspace(0, 2 * np.pi, 9)[:-1]
        ]
    )                                                     # [9,2]
    pts = centers[:, None, :] + ring[None, :, :] * np.asarray(radii)[:, None, None]
    # 256 comparison pairs out of the 903 possible, seeded + deduped,
    # biased to include every field at least once (coarse-to-fine mix)
    all_pairs = np.array([(i, j) for i in range(43) for j in range(i + 1, 43)])
    sel = rng.permutation(len(all_pairs))[:N_BITS]
    return pts.astype(np.float32), all_pairs[sel].astype(np.int32)


def describe_freak(img_blurred: jnp.ndarray, xy: jnp.ndarray):
    """FREAK-style binary descriptor: averaged retinal field intensities,
    rotation-steered comparisons, packed to uint32 [K,8]."""
    pts_np, pairs_np = _freak_pattern()
    patches = extract_patches(img_blurred, xy)           # [K,31,31]
    angles = ic_angle(patches)
    K = patches.shape[0]

    pts = jnp.asarray(pts_np)                            # [43,9,2]
    ca, sa = jnp.cos(angles), jnp.sin(angles)            # [K]
    px, py = pts[..., 0], pts[..., 1]                    # [43,9]
    rx = px[None] * ca[:, None, None] - py[None] * sa[:, None, None]
    ry = px[None] * sa[:, None, None] + py[None] * ca[:, None, None]
    ix = jnp.clip(jnp.round(rx).astype(jnp.int32), -PATCH_RADIUS, PATCH_RADIUS)
    iy = jnp.clip(jnp.round(ry).astype(jnp.int32), -PATCH_RADIUS, PATCH_RADIUS)
    idx = (iy + PATCH_RADIUS) * PATCH + (ix + PATCH_RADIUS)  # [K,43,9]

    flat = patches.reshape(K, PATCH * PATCH)
    vals = jnp.take_along_axis(flat, idx.reshape(K, -1), axis=1)
    fields = vals.reshape(K, 43, 9).mean(axis=-1)        # [K,43]

    pairs = jnp.asarray(pairs_np)                        # [256,2]
    bits = fields[:, pairs[:, 0]] < fields[:, pairs[:, 1]]
    return pack_bits(bits), angles


# --------------------------------------------------------------------------
# LATCH-style: triplet mini-patch comparisons
# --------------------------------------------------------------------------

_LATCH_HALF = 1  # 3x3 mini-patches (cv::xfeatures2d::LATCH half_ssd_size=3's
                 # companion default is 3x3 windows)


@functools.lru_cache(maxsize=1)
def _latch_pattern() -> np.ndarray:
    """[256, 3, 2] float32: (anchor, p1, p2) mini-patch centers per bit,
    inside radius 12 so rotated 3x3 windows stay in the 31x31 patch."""
    rng = np.random.default_rng(0x1A7C4)
    lim = PATCH_RADIUS - _LATCH_HALF - 2  # 12
    out = np.empty((N_BITS, 3, 2), np.float64)
    n = 0
    while n < N_BITS:
        cand = rng.normal(0.0, PATCH / 6.0, (3, 2))
        if np.all(np.linalg.norm(cand, axis=1) <= lim) and (
            np.linalg.norm(cand[1] - cand[2]) > 1.5
        ):
            out[n] = cand
            n += 1
    return out.astype(np.float32)


def describe_latch(img_blurred: jnp.ndarray, xy: jnp.ndarray):
    """LATCH-style binary descriptor: bit b is
    SSD(anchor_b, p1_b) < SSD(anchor_b, p2_b) over rotated 3x3 windows."""
    tri_np = _latch_pattern()                            # [256,3,2]
    patches = extract_patches(img_blurred, xy)           # [K,31,31]
    angles = ic_angle(patches)
    K = patches.shape[0]

    # window offsets around each mini-patch center (un-rotated, shared);
    # rotating window offsets too would resample identically for all three
    # patches of a triplet, so SSD ordering is preserved — rotate centers only
    offs = np.stack(
        np.meshgrid(
            np.arange(-_LATCH_HALF, _LATCH_HALF + 1),
            np.arange(-_LATCH_HALF, _LATCH_HALF + 1),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 2)[:, ::-1]                            # [9,2] (x,y)

    centers = tri_np.reshape(-1, 2)                      # [768,2]
    ca, sa = jnp.cos(angles), jnp.sin(angles)
    cx = jnp.asarray(centers[:, 0])
    cy = jnp.asarray(centers[:, 1])
    rx = cx[None] * ca[:, None] - cy[None] * sa[:, None]  # [K,768]
    ry = cx[None] * sa[:, None] + cy[None] * ca[:, None]

    ox = jnp.asarray(offs[:, 0].astype(np.float32))      # [9]
    oy = jnp.asarray(offs[:, 1].astype(np.float32))
    sx = rx[:, :, None] + ox[None, None, :]              # [K,768,9]
    sy = ry[:, :, None] + oy[None, None, :]
    ix = jnp.clip(jnp.round(sx).astype(jnp.int32), -PATCH_RADIUS, PATCH_RADIUS)
    iy = jnp.clip(jnp.round(sy).astype(jnp.int32), -PATCH_RADIUS, PATCH_RADIUS)
    idx = (iy + PATCH_RADIUS) * PATCH + (ix + PATCH_RADIUS)

    flat = patches.reshape(K, PATCH * PATCH)
    vals = jnp.take_along_axis(flat, idx.reshape(K, -1), axis=1)
    windows = vals.reshape(K, N_BITS, 3, 9)              # anchor, p1, p2
    ssd1 = jnp.sum((windows[:, :, 0] - windows[:, :, 1]) ** 2, axis=-1)
    ssd2 = jnp.sum((windows[:, :, 0] - windows[:, :, 2]) ** 2, axis=-1)
    return pack_bits(ssd1 < ssd2), angles


# --------------------------------------------------------------------------
# SIFT-style float descriptor (4x4 cells x 8 orientation bins)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _sift_grid() -> tuple[np.ndarray, np.ndarray]:
    """16x16 sample grid in the kp frame: (offsets [256,2] float32,
    spatial weights [256,16] float32 — bilinear share of each sample into
    the 4x4 descriptor cells, Gaussian-windowed)."""
    step = 24.0 / 16.0  # 24-px descriptor window inside the 31-px patch
    coords = (np.arange(16) - 7.5) * step
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    offs = np.stack([gx.ravel(), gy.ravel()], axis=-1)   # [256,2] (x,y)

    # continuous cell coordinates in [0,4): sample -> (cx, cy)
    cell = (offs / (4.0 * step)) + 2.0 - 0.5             # center-of-cell frame
    w = np.zeros((256, 16), np.float64)
    sigma = 8.0
    gauss = np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2 * sigma * sigma))
    for s in range(256):
        cx, cy = cell[s]
        for iy in (int(np.floor(cy)), int(np.floor(cy)) + 1):
            for ix in (int(np.floor(cx)), int(np.floor(cx)) + 1):
                if 0 <= ix < 4 and 0 <= iy < 4:
                    wxy = (1 - abs(cx - ix)) * (1 - abs(cy - iy))
                    w[s, iy * 4 + ix] = wxy * gauss[s]
    return offs.astype(np.float32), w.astype(np.float32)


def describe_sift(img_blurred: jnp.ndarray, xy: jnp.ndarray):
    """SIFT-style 128-d float descriptor, rotation-steered, L2-normalized
    with the 0.2 clip + renormalize of the original recipe.

    Gradients are sampled along the rotated axes (finite differences between
    rotated-grid gathers), so orientations are already relative to the kp
    angle.  Returns ([K,128] float32, angle [K]).
    """
    offs_np, wmat_np = _sift_grid()
    patches = extract_patches(img_blurred, xy)           # [K,31,31]
    angles = ic_angle(patches)
    K = patches.shape[0]
    flat = patches.reshape(K, PATCH * PATCH)

    ca, sa = jnp.cos(angles), jnp.sin(angles)
    offs = jnp.asarray(offs_np)                          # [256,2]

    def gather_at(dx: float, dy: float):
        px = offs[:, 0] + dx
        py = offs[:, 1] + dy
        rx = px[None] * ca[:, None] - py[None] * sa[:, None]
        ry = px[None] * sa[:, None] + py[None] * ca[:, None]
        ix = jnp.clip(jnp.round(rx).astype(jnp.int32), -PATCH_RADIUS, PATCH_RADIUS)
        iy = jnp.clip(jnp.round(ry).astype(jnp.int32), -PATCH_RADIUS, PATCH_RADIUS)
        idx = (iy + PATCH_RADIUS) * PATCH + (ix + PATCH_RADIUS)
        return jnp.take_along_axis(flat, idx, axis=1)    # [K,256]

    gx = 0.5 * (gather_at(1.0, 0.0) - gather_at(-1.0, 0.0))
    gy = 0.5 * (gather_at(0.0, 1.0) - gather_at(0.0, -1.0))
    mag = jnp.sqrt(gx * gx + gy * gy)                    # [K,256]
    ori = jnp.arctan2(gy, gx)                            # relative to kp frame

    # soft orientation binning into 8 bins (linear interpolation)
    bin_f = (ori + jnp.pi) * (8.0 / (2.0 * jnp.pi))      # [0,8)
    b0 = jnp.floor(bin_f)
    frac = bin_f - b0
    b0i = jnp.mod(b0.astype(jnp.int32), 8)
    b1i = jnp.mod(b0i + 1, 8)
    bins = jnp.arange(8)
    obin = (
        (bins[None, None] == b0i[..., None]) * (1.0 - frac[..., None])
        + (bins[None, None] == b1i[..., None]) * frac[..., None]
    )                                                    # [K,256,8]

    wmat = jnp.asarray(wmat_np)                          # [256,16]
    hist = jnp.einsum("ks,sc,ksb->kcb", mag, wmat, obin) # [K,16,8]
    d = hist.reshape(K, SIFT_DIM)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-8)
    d = jnp.minimum(d, 0.2)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-8)
    return d, angles


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def describe_orb(img_blurred: jnp.ndarray, xy: jnp.ndarray):
    from aslam.ops import orb

    return orb.describe(img_blurred, xy)


DESCRIPTOR_ALIASES = {
    "ORB_SLAM2": "ORB",
    "RBRIEF": "ORB",
    "BRISK": "FREAK",   # both are retinal binary patterns; one impl serves
    "SURF": "SIFT",     # float gradient-histogram family
}

_DESCRIBE_FNS = {
    "ORB": describe_orb,
    "BRIEF": describe_brief,
    "FREAK": describe_freak,
    "LATCH": describe_latch,
    "SIFT": describe_sift,
}


def canonical(name: str) -> str:
    n = name.upper()
    n = DESCRIPTOR_ALIASES.get(n, n)
    if n not in _DESCRIBE_FNS:
        raise ValueError(
            f"unknown descriptor {name!r}; have {sorted(_DESCRIBE_FNS)} "
            f"(+ aliases {sorted(DESCRIPTOR_ALIASES)})"
        )
    return n


def is_binary(name: str) -> bool:
    """True -> packed uint32[...,8] Hamming descriptors; False -> float L2
    (the reference's Extractor::mNorm switch, extractor.cpp:36)."""
    return canonical(name) != "SIFT"


def describe(name: str, img_blurred: jnp.ndarray, xy: jnp.ndarray):
    return _DESCRIBE_FNS[canonical(name)](img_blurred, xy)
