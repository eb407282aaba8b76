"""FAST-9/16 corner detection as a dense, whole-image XLA computation.

Replaces the per-cell `cv::FAST` calls of the reference
(orbextractor.cpp:665-746: FAST threshold 20 with fallback 7 inside 30-px
cells) and the per-cell `DetectorAdjuster` thresholds of the adaptive stack
(detectoradjuster.cpp:22-54).  Instead of scalar ring tests per pixel in C++,
the whole image is tested at once: 16 shifted views of the image, vectorized
brighter/darker ring masks, contiguous-arc reduction, and a V-shaped corner
score — all fusable elementwise ops on the VPU.

Supports a *per-pixel threshold map* so the adaptive grid controller
(3x3 cells, reference extractor.cpp:65-76) is just a broadcast of a [3,3]
array — no per-cell detector objects.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12 o'clock.
# (dy, dx) offsets — the standard ring used by every FAST implementation.
RING_16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9: at least 9 contiguous ring pixels all brighter/darker


def _shifted_ring(img: jnp.ndarray) -> jnp.ndarray:
    """[H,W] -> [16,H,W]: ring pixel p_i at each center location.

    Uses jnp.roll; the 3-px border is invalid and masked by the caller.
    """
    views = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for (dy, dx) in RING_16]
    return jnp.stack(views, axis=0)


def fast_response(img: jnp.ndarray, threshold) -> jnp.ndarray:
    """FAST-9/16 corner response map.

    img: [H,W] float32.  threshold: scalar or broadcastable [H,W] map.
    Returns [H,W] float32 response; 0 where not a corner.  Response is the
    V-score: max over contiguous 9-arcs of the minimum margin |p_i - p| - t
    within the arc (same ordering semantics as OpenCV's FAST score, which the
    reference relies on for retainBest / quad-tree ordering).
    """
    t = jnp.asarray(threshold, img.dtype)
    ring = _shifted_ring(img)                    # [16,H,W]
    center = img[None]
    diff = ring - center                         # [16,H,W]
    bright_margin = diff - t                     # >0 where ring brighter by >t
    dark_margin = -diff - t                      # >0 where ring darker by >t

    # wrap-around windows: append first ARC_LEN-1 entries
    bm = jnp.concatenate([bright_margin, bright_margin[: ARC_LEN - 1]], axis=0)
    dm = jnp.concatenate([dark_margin, dark_margin[: ARC_LEN - 1]], axis=0)

    # min over each length-9 arc, max over the 16 arc positions
    def arc_score(m):
        # m: [16+8, H, W] -> [H, W]
        mins = None
        for s in range(16):
            window_min = m[s]
            for o in range(1, ARC_LEN):
                window_min = jnp.minimum(window_min, m[s + o])
            mins = window_min if mins is None else jnp.maximum(mins, window_min)
        return mins

    score = jnp.maximum(arc_score(bm), arc_score(dm))
    score = jnp.maximum(score, 0.0)

    # 3px ring border is garbage from the rolls
    H, W = img.shape
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    border = (row >= 3) & (row < H - 3) & (col >= 3) & (col < W - 3)
    return jnp.where(border, score, 0.0)


def nms_3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression: keep score only at local maxima.

    Equivalent to cv::FAST(nonmaxSuppression=true) used by the reference.
    Ties on flat plateaus are broken deterministically by raster order so
    each plateau yields exactly one keypoint (OpenCV's scan order does the
    same implicitly).
    """
    import jax

    H, W = score.shape
    # strictly increasing raster-order epsilon in [0, 0.5): large enough to
    # survive f32 addition against typical scores (intensity-scale numbers),
    # small enough not to reorder meaningfully different responses
    eps = (
        jnp.arange(H * W, dtype=jnp.float32).reshape(H, W)
        * (0.5 / (H * W))
    )
    keyed = jnp.where(score > 0, score + eps, 0.0)
    neighborhood_max = jax.lax.reduce_window(
        keyed, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(keyed >= neighborhood_max, score, 0.0)


def detect(img: jnp.ndarray, threshold) -> jnp.ndarray:
    """FAST + NMS in one call."""
    return nms_3x3(fast_response(img, threshold))


def threshold_map_from_grid(
    grid_thresholds: jnp.ndarray, height: int, width: int
) -> jnp.ndarray:
    """Broadcast a [gy,gx] per-cell threshold grid to a full [H,W] map.

    This is the whole of the reference's VideoGridAdaptedFeatureDetector
    machinery (one cloned stateful detector per cell,
    videogridadaptedfeaturedetector.cpp:60-81) collapsed into an array
    broadcast.
    """
    gy, gx = grid_thresholds.shape
    rows = jnp.minimum((jnp.arange(height) * gy) // height, gy - 1)
    cols = jnp.minimum((jnp.arange(width) * gx) // width, gx - 1)
    # expand via two small one-hot matmuls instead of a [H,W] gather;
    # exact because the one-hot rows select single cells
    R = (rows[:, None] == jnp.arange(gy)[None, :]).astype(
        grid_thresholds.dtype)                             # [H,gy]
    C = (cols[:, None] == jnp.arange(gx)[None, :]).astype(
        grid_thresholds.dtype)                             # [W,gx]
    return R @ grid_thresholds @ C.T


def counts_per_grid_cell(
    score: jnp.ndarray, gy: int, gx: int
) -> jnp.ndarray:
    """Count detected corners (score>0) per adaptive grid cell -> [gy,gx].

    Implemented as two small 0/1 aggregation matmuls (R @ hits @ C^T)
    instead of a [H*W]-update scatter-add."""
    H, W = score.shape
    rows = jnp.minimum((jnp.arange(H) * gy) // H, gy - 1)
    cols = jnp.minimum((jnp.arange(W) * gx) // W, gx - 1)
    R = (rows[None, :] == jnp.arange(gy)[:, None]).astype(jnp.float32)
    C = (cols[None, :] == jnp.arange(gx)[:, None]).astype(jnp.float32)
    hits = (score > 0).astype(jnp.float32)
    counts = R @ hits @ C.T
    return jnp.round(counts).astype(jnp.int32)


def adaptive_threshold_update(
    grid_thresholds: jnp.ndarray,
    counts: jnp.ndarray,
    min_count: float,
    max_count: float,
    down: float = 0.7,
    up: float = 1.3,
    th_min: float = 2.0,
    th_max: float = 80.0,
) -> jnp.ndarray:
    """Per-cell threshold controller update, carried across video frames.

    Reference semantics (detectoradjuster.cpp:42-54 +
    videodynamicadaptedfeaturedetector.cpp:24-44): too few keypoints in a
    cell -> threshold *= 0.7 (more sensitive); too many -> threshold *= 1.3;
    clamped to [th_min, th_max].  `min_count`/`max_count` are per-cell bounds
    (the reference divides the 600..1020 global band by the cell count).
    """
    too_few = counts < min_count
    too_many = counts > max_count
    scale = jnp.where(too_few, down, jnp.where(too_many, up, 1.0))
    return jnp.clip(grid_thresholds * scale, th_min, th_max)
