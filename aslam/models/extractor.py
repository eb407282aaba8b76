"""Adaptive multi-scale ORB extractor — the feature front-end facade.

Replaces the reference Extractor stack (SURVEY.md components 11-16):
`Extractor::Extract` (extractor.cpp:39-47), `ORBextractor::operator()`
(orbextractor.cpp:756-830), and the adaptive grid/threshold controllers
(detectoradjuster.cpp, videodynamicadaptedfeaturedetector.cpp,
videogridadaptedfeaturedetector.cpp).

Pipeline per frame (all jitted, one compile per image geometry):
  1. 8-level x1.2 image pyramid (ops/pyramid.py)
  2. per-level FAST-9 response with a per-pixel threshold map broadcast from
     the adaptive 3x3 grid state, + 3x3 NMS (ops/fast.py)
  3. per-level grid-bucketed top-k spatial distribution (ops/select.py),
     quota per level = geometric allocation of n_features
  4. Gaussian blur + IC-angle + rBRIEF descriptors (ops/orb.py)
  5. concatenate levels into fixed-capacity [max_keypoints] arrays with a
     validity mask; coordinates mapped to level-0 pixels
  6. adaptive state update from per-cell corner counts
     (tooFew x0.7 / tooMany x1.3, extractor.cpp:56-76 semantics)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import ExtractorConfig
from aslam.ops import desc as desc_ops
from aslam.ops import detectors, fast, orb, pyramid, select


class Features(NamedTuple):
    """Per-frame keypoint set, padded to config.max_keypoints."""

    xy: jnp.ndarray        # [M,2] float32 level-0 pixel coords (x, y)
    response: jnp.ndarray  # [M] float32
    angle: jnp.ndarray     # [M] float32 radians
    octave: jnp.ndarray    # [M] int32 pyramid level
    desc: jnp.ndarray      # [M,8] uint32 packed binary, or [M,128] float32
    valid: jnp.ndarray     # [M] bool


class AdaptiveState(NamedTuple):
    """Per-cell detector thresholds carried across frames (the 'Video' part
    of VideoDynamicAdaptedFeatureDetector: state persists between frames)."""

    grid_thresholds: jnp.ndarray  # [gy,gx] float32


def detector_params(cfg: ExtractorConfig) -> tuple[float, float, float]:
    """(initial threshold, clamp min, clamp max) for cfg.detector.

    FAST keeps the config's explicit FAST fields (reference initial
    thresholds per detector family: extractor.cpp:56-63); other families use
    their calibrated defaults from ops/detectors.py.
    """
    if detectors.canonical(cfg.detector) == "FAST":
        return (
            float(cfg.fast_threshold),
            float(cfg.adaptive_th_min),
            float(cfg.adaptive_th_max),
        )
    d = detectors.defaults(cfg.detector)
    return d["threshold"], d["th_min"], d["th_max"]


def init_adaptive_state(cfg: ExtractorConfig) -> AdaptiveState:
    g = cfg.adaptive_grid
    th0, _, _ = detector_params(cfg)
    return AdaptiveState(
        grid_thresholds=jnp.full((g, g), th0, jnp.float32)
    )


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def _extract_impl(
    img: jnp.ndarray,
    grid_thresholds: jnp.ndarray,
    cfg: ExtractorConfig,
    height: int,
    width: int,
):
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    quotas = cfg.features_per_level
    scales = cfg.scale_factors
    det = detectors.canonical(cfg.detector)
    _, th_lo, th_hi = detector_params(cfg)

    def response(img_l, th_map):
        return detectors.response(det, img_l, th_map)

    if cfg.adaptive and cfg.adaptive_iters > 1:
        # intra-frame controller iterations (the reference's
        # VideoDynamicAdaptedFeatureDetector retries detection up to 5x
        # within one frame until the count lands in band,
        # videodynamicadaptedfeaturedetector.cpp:24-44).  Counting passes
        # are FAST-only (no NMS/descriptors) and cheap.
        # counting runs on the base level only: the reference's ADAPTIVE
        # mode wraps a single-scale detector (extractor.cpp:52-77), and
        # level 0 carries the bulk of detections — one FAST pass per
        # retry instead of n_levels
        n_cells = cfg.adaptive_grid * cfg.adaptive_grid
        base = levels[0]
        h0, w0 = base.shape
        for _ in range(cfg.adaptive_iters - 1):
            th0 = fast.threshold_map_from_grid(grid_thresholds, h0, w0)
            counts = fast.counts_per_grid_cell(
                fast.nms_3x3(response(base, th0)),
                cfg.adaptive_grid, cfg.adaptive_grid)
            grid_thresholds = fast.adaptive_threshold_update(
                grid_thresholds, counts,
                min_count=cfg.adaptive_min / n_cells,
                max_count=cfg.adaptive_max / n_cells,
                down=cfg.adaptive_down, up=cfg.adaptive_up,
                th_min=th_lo, th_max=th_hi,
            )

    all_xy, all_resp, all_valid, all_oct = [], [], [], []
    all_desc, all_angle = [], []
    total_counts = jnp.zeros(
        (cfg.adaptive_grid, cfg.adaptive_grid), jnp.int32
    )

    for l, img_l in enumerate(levels):
        h, w = img_l.shape
        th_map = fast.threshold_map_from_grid(grid_thresholds, h, w)
        resp_raw = response(img_l, th_map)
        if not cfg.adaptive:
            # static mode keeps the reference's per-cell fallback
            # (orbextractor.cpp:665-746: cells empty at threshold 20 retry
            # at 7) — cells of the detection grid with no corners get a
            # second detection pass at the minimum threshold
            g = cfg.adaptive_grid
            fallback_th = (float(cfg.fast_threshold_min)
                           if det == "FAST" else th_lo)
            counts0 = fast.counts_per_grid_cell(resp_raw, g, g)
            weak_cells = counts0 == 0
            th_low_map = fast.threshold_map_from_grid(
                jnp.where(weak_cells, fallback_th, grid_thresholds), h, w)
            weak_px = fast.threshold_map_from_grid(
                weak_cells.astype(jnp.float32), h, w) > 0
            resp_raw = jnp.where(
                weak_px, response(img_l, th_low_map), resp_raw)
        resp = fast.nms_3x3(resp_raw)
        # keep descriptors' patches inside the image: kill a border strip
        b = orb.PATCH_RADIUS + 1
        row = jnp.arange(h)[:, None]
        col = jnp.arange(w)[None, :]
        interior = (row >= b) & (row < h - b) & (col >= b) & (col < w - b)
        resp = jnp.where(interior, resp, 0.0)

        total_counts = total_counts + fast.counts_per_grid_cell(
            resp, cfg.adaptive_grid, cfg.adaptive_grid
        )

        n_l = max(int(quotas[l]), 1)
        # oversample then let the global merge keep the best
        xy_l, resp_l, valid_l = select.grid_topk(
            resp, cfg.cell_px, k_cell=cfg.cell_topk, n_out=n_l
        )
        # sub-pixel localization on the PRE-NMS response surface (NMS zeroes
        # the neighbors the parabola fit needs); descriptors still gather at
        # rounded coords, pose estimation uses the refined uv
        xy_l = select.subpixel_refine(resp_raw, xy_l)

        img_blur = pyramid.gaussian_blur(img_l)
        desc_l, angle_l = desc_ops.describe(cfg.descriptor, img_blur, xy_l)

        all_xy.append(xy_l * scales[l])       # map to level-0 coords
        all_resp.append(resp_l)
        all_valid.append(valid_l)
        all_oct.append(jnp.full((n_l,), l, jnp.int32))
        all_desc.append(desc_l)
        all_angle.append(angle_l)

    xy = jnp.concatenate(all_xy)
    resp = jnp.concatenate(all_resp)
    valid = jnp.concatenate(all_valid)
    octv = jnp.concatenate(all_oct)
    desc = jnp.concatenate(all_desc)
    angle = jnp.concatenate(all_angle)

    M = cfg.max_keypoints
    n_cand = xy.shape[0]
    if n_cand >= M:
        # keep the M best by (valid, response)
        key = jnp.where(valid, resp, -1.0)
        _, sel = jax.lax.top_k(key, M)
        xy, resp, angle, octv, desc, valid = (
            xy[sel], resp[sel], angle[sel], octv[sel], desc[sel], valid[sel]
        )
    else:
        pad = M - n_cand
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        resp = jnp.pad(resp, (0, pad))
        angle = jnp.pad(angle, (0, pad))
        octv = jnp.pad(octv, (0, pad))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))

    feats = Features(
        xy=xy, response=resp, angle=angle, octave=octv, desc=desc, valid=valid
    )

    # adaptive controller update (per-cell band = global band / n_cells)
    n_cells = cfg.adaptive_grid * cfg.adaptive_grid
    new_grid = fast.adaptive_threshold_update(
        grid_thresholds,
        total_counts,
        min_count=cfg.adaptive_min / n_cells,
        max_count=cfg.adaptive_max / n_cells,
        down=cfg.adaptive_down,
        up=cfg.adaptive_up,
        th_min=th_lo,
        th_max=th_hi,
    )
    if not cfg.adaptive:
        new_grid = grid_thresholds
    return feats, new_grid


class Extractor:
    """Stateful facade: owns the adaptive threshold grid across a video."""

    def __init__(self, cfg: ExtractorConfig):
        self.cfg = cfg
        self.state = init_adaptive_state(cfg)

    def extract(self, img: jnp.ndarray) -> Features:
        """img: [H,W] float32 grayscale -> Features (updates adaptive state)."""
        h, w = img.shape
        feats, new_grid = _extract_impl(img, self.state.grid_thresholds,
                                        self.cfg, h, w)
        self.state = AdaptiveState(grid_thresholds=new_grid)
        return feats


def extract_features(
    img: jnp.ndarray, cfg: ExtractorConfig, state: AdaptiveState | None = None
):
    """Functional entry: -> (Features, AdaptiveState)."""
    if state is None:
        state = init_adaptive_state(cfg)
    h, w = img.shape
    feats, new_grid = _extract_impl(img, state.grid_thresholds, cfg, h, w)
    return feats, AdaptiveState(grid_thresholds=new_grid)
