"""Dense corner/blob response maps for the alternate detector families.

The reference's Extractor facade exposes a detector enum algebra
{ORB, ORB_SLAM2, FAST, GFTT, STAR, BRISK, SURF, SIFT, ...} x
{NORMAL, ADAPTIVE} (extractor.h:8-25, extractor.cpp:52-134).  Each OpenCV
detector there is a per-image scalar loop; here every family is a dense
whole-image response map (VPU elementwise + tiny stencils) that plugs into
the same NMS -> grid-top-k -> adaptive-threshold pipeline as FAST
(ops/fast.py), so ADAPTIVE mode works for every family — the reference's
DetectorAdjuster only supported FAST/ORB/SURF/SIFT (detectoradjuster.cpp:22-36).

All responses are mapped to **intensity-like units** (0..255-scale images)
so one threshold-controller configuration drives every family; per-family
defaults live in `DETECTOR_DEFAULTS` (the reference used native units with
per-detector initial thresholds: FAST/ORB 20, SURF 200, SIFT 0.04 —
extractor.cpp:56-63).

Signature contract (same as fast.fast_response): ``response(img, threshold)``
with ``img [H,W] float32`` and scalar-or-[H,W] ``threshold``; returns a
[H,W] float32 map that is 0 where no detection and a comparable saliency
score elsewhere.  FAST itself stays in ops/fast.py.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
from jax import lax

from aslam.ops import fast, pyramid


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def _box_sum(img: jnp.ndarray, n: int) -> jnp.ndarray:
    """Sum over an n x n window (SAME padding)."""
    return lax.reduce_window(img, 0.0, lax.add, (n, n), (1, 1), "SAME")


def sobel_gradients(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel derivatives (Ix, Iy), normalized to intensity/pixel units."""
    def sh(dy, dx):
        return jnp.roll(img, (-dy, -dx), axis=(0, 1))

    # smoothed central differences: [1,2,1]^T x [-1,0,1] / 8
    ix = (
        (sh(-1, 1) - sh(-1, -1))
        + 2.0 * (sh(0, 1) - sh(0, -1))
        + (sh(1, 1) - sh(1, -1))
    ) * 0.125
    iy = (
        (sh(1, -1) - sh(-1, -1))
        + 2.0 * (sh(1, 0) - sh(-1, 0))
        + (sh(1, 1) - sh(-1, 1))
    ) * 0.125
    return ix, iy


def structure_tensor(
    img: jnp.ndarray, block: int = 3
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(Sxx, Sxy, Syy): gradient outer products averaged over block x block."""
    ix, iy = sobel_gradients(img)
    inv = 1.0 / (block * block)
    return (
        _box_sum(ix * ix, block) * inv,
        _box_sum(ix * iy, block) * inv,
        _box_sum(iy * iy, block) * inv,
    )


def _border_mask(img: jnp.ndarray, b: int) -> jnp.ndarray:
    H, W = img.shape
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    return (row >= b) & (row < H - b) & (col >= b) & (col < W - b)


def _gate(raw: jnp.ndarray, threshold, border: int) -> jnp.ndarray:
    t = jnp.asarray(threshold, raw.dtype)
    r = jnp.where(raw > t, raw, 0.0)
    return jnp.where(_border_mask(raw, border), r, 0.0)


# --------------------------------------------------------------------------
# detector families
# --------------------------------------------------------------------------

def gftt_response(img: jnp.ndarray, threshold) -> jnp.ndarray:
    """Shi-Tomasi min-eigenvalue corners (cv::GFTTDetector semantics).

    Response = sqrt(min-eig of the 3x3-averaged structure tensor), i.e.
    gradient-magnitude (intensity) units.
    """
    sxx, sxy, syy = structure_tensor(img)
    half_tr = 0.5 * (sxx + syy)
    disc = jnp.sqrt(jnp.maximum((0.5 * (sxx - syy)) ** 2 + sxy * sxy, 0.0))
    min_eig = jnp.maximum(half_tr - disc, 0.0)
    return _gate(jnp.sqrt(min_eig), threshold, border=3)


def harris_response(img: jnp.ndarray, threshold, k: float = 0.04) -> jnp.ndarray:
    """Harris corner score, 4th-rooted into intensity units."""
    sxx, sxy, syy = structure_tensor(img)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    r = jnp.maximum(det - k * tr * tr, 0.0)
    return _gate(jnp.sqrt(jnp.sqrt(r)), threshold, border=3)


def dog_response(
    img: jnp.ndarray, threshold, sigma: float = 1.0, k: float = 1.6
) -> jnp.ndarray:
    """Difference-of-Gaussians blob response (SIFT detector per level).

    Scale extrema across octaves come from the caller's pyramid; within a
    level, |DoG| local maxima are the blob centers.  Intensity-difference
    units (SIFT's 0.04-of-1.0 contrast gate ~ 10 on 0..255 images; the DoG
    band-pass passes a fraction of that — default threshold in
    DETECTOR_DEFAULTS is calibrated accordingly).
    """
    g1 = pyramid.gaussian_blur(img, ksize=7, sigma=sigma)
    g2 = pyramid.gaussian_blur(img, ksize=9, sigma=sigma * k)
    return _gate(jnp.abs(g1 - g2), threshold, border=4)


def hessian_response(
    img: jnp.ndarray, threshold, sigma: float = 1.2
) -> jnp.ndarray:
    """Determinant-of-Hessian blob response (cv::xfeatures2d::SURF detector
    semantics, exact second derivatives instead of box-filter approximations).

    Response = sqrt(max(det H, 0)) in intensity units (SURF's native
    hessianThreshold 200 corresponds to its box-filter scale; the reference
    initializes the SURF adjuster there, extractor.cpp:58).
    """
    g = pyramid.gaussian_blur(img, ksize=7, sigma=sigma)

    def sh(dy, dx):
        return jnp.roll(g, (-dy, -dx), axis=(0, 1))

    dxx = sh(0, 1) - 2.0 * g + sh(0, -1)
    dyy = sh(1, 0) - 2.0 * g + sh(-1, 0)
    dxy = 0.25 * (sh(1, 1) - sh(1, -1) - sh(-1, 1) + sh(-1, -1))
    det = dxx * dyy - dxy * dxy
    return _gate(jnp.sqrt(jnp.maximum(det, 0.0)), threshold, border=4)


def star_response(
    img: jnp.ndarray, threshold, scales: tuple[int, ...] = (2, 4, 6)
) -> jnp.ndarray:
    """Center-surround (CenSurE / cv::xfeatures2d::StarDetector family)
    bi-level difference-of-boxes response, max over scales.

    Per scale s: |mean(box (2s+1)) - mean(box (4s+1))|, intensity units.
    """
    resp = None
    for s in scales:
        inner_n = 2 * s + 1
        outer_n = 4 * s + 1
        inner = _box_sum(img, inner_n) / float(inner_n * inner_n)
        outer = _box_sum(img, outer_n) / float(outer_n * outer_n)
        r = jnp.abs(inner - outer)
        resp = r if resp is None else jnp.maximum(resp, r)
    return _gate(resp, threshold, border=2 * max(scales))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

# name -> (response_fn, defaults).  Thresholds are in the response's
# intensity-like units and were calibrated on the synthetic TUM-shaped render
# to land inside the adaptive band (600..1020 kp) within a few controller
# steps; the x0.7 / x1.3 controller makes the initial value uncritical.
ResponseFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]

DETECTOR_DEFAULTS: dict[str, dict[str, float]] = {
    "FAST": dict(threshold=20.0, th_min=2.0, th_max=80.0),
    "GFTT": dict(threshold=15.0, th_min=1.5, th_max=120.0),
    "HARRIS": dict(threshold=10.0, th_min=1.0, th_max=90.0),
    "DOG": dict(threshold=2.0, th_min=0.2, th_max=30.0),
    "HESSIAN": dict(threshold=4.0, th_min=0.4, th_max=60.0),
    "STAR": dict(threshold=8.0, th_min=0.8, th_max=80.0),
}

# reference enum spellings (extractor.h:8-17) -> families here
DETECTOR_ALIASES = {
    "ORB": "FAST",        # ORB's detector is FAST + Harris ordering
    "ORB_SLAM2": "FAST",
    "BRISK": "FAST",      # BRISK's detector is AGAST, a FAST variant
    "AGAST": "FAST",
    "SIFT": "DOG",
    "SURF": "HESSIAN",
    "SHI_TOMASI": "GFTT",
    "CENSURE": "STAR",
}

_RESPONSE_FNS: dict[str, ResponseFn] = {
    "FAST": fast.fast_response,
    "GFTT": gftt_response,
    "HARRIS": harris_response,
    "DOG": dog_response,
    "HESSIAN": hessian_response,
    "STAR": star_response,
}


def canonical(name: str) -> str:
    n = name.upper()
    n = DETECTOR_ALIASES.get(n, n)
    if n not in _RESPONSE_FNS:
        raise ValueError(
            f"unknown detector {name!r}; have {sorted(_RESPONSE_FNS)} "
            f"(+ aliases {sorted(DETECTOR_ALIASES)})"
        )
    return n


def response(name: str, img: jnp.ndarray, threshold) -> jnp.ndarray:
    """Dispatch a detector family by name (accepts reference enum aliases)."""
    return _RESPONSE_FNS[canonical(name)](img, threshold)


def defaults(name: str) -> dict[str, float]:
    return DETECTOR_DEFAULTS[canonical(name)]
