"""Visual-odometry driver: frame-to-frame tracking without mapping.

This is BASELINE config 1 ("TUM fr1/xyz frame-to-frame odometry, no
mapping") — the minimum end-to-end slice (SURVEY.md §7.2 step 4).  Host
Python orchestrates the loop; all math is the jitted `rba_step`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import SystemConfig
from aslam.models import frame as frame_mod
from aslam.models.extractor import init_adaptive_state
from aslam.models.odometry import track_frame


class VisualOdometry:
    def __init__(self, cfg: SystemConfig, seed: int = 0,
                 collect_stats: bool = True):
        self.cfg = cfg
        self.adaptive = init_adaptive_state(cfg.extractor)
        self.prev: frame_mod.FrameData | None = None
        self.key = jax.random.PRNGKey(seed)
        self.poses: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.stats: list[dict] = []
        # collect_stats pulls four scalars per frame (device->host sync);
        # disable it to keep the device queue full (bench.py uses the raw
        # jitted functions directly for the same reason)
        self.collect_stats = collect_stats

    def process(self, img: np.ndarray, depth: np.ndarray, t: float = 0.0) -> np.ndarray:
        """Feed one RGB-D frame; returns the estimated T_cw [4,4]."""
        if self.prev is None:
            f, self.adaptive = frame_mod.make_frame(
                jnp.asarray(img), jnp.asarray(depth), self.cfg, self.adaptive,
            )
            f = frame_mod.with_pose(f, jnp.eye(4))
        else:
            # fused extraction+odometry: one device dispatch per frame
            self.key, sub = jax.random.split(self.key)
            h, w = img.shape[:2]
            f, new_grid, res = track_frame(
                self.prev, jnp.asarray(img), jnp.asarray(depth),
                self.adaptive.grid_thresholds, sub, self.cfg, h, w,
            )
            self.adaptive = self.adaptive._replace(grid_thresholds=new_grid)
            if self.collect_stats:
                self.stats.append({
                    "n_matches": int(res.n_matches),
                    "n_inliers": int(res.n_inliers),
                    "rmse": float(res.rmse),
                    "ba_inliers": int(res.ba_inliers),
                })
        self.prev = f
        T = np.asarray(f.T_cw)
        self.poses.append(T)
        self.timestamps.append(t)
        return T
