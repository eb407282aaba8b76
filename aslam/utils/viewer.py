"""Offline map/trajectory visualization + HUD counters.

Replaces the Pangolin viewer thread (reference Drawer/viewer.cpp,
mapdrawer.cpp: live GL window with landmark points, keyframe frusta,
covisibility/spanning-tree edges, HUD counters).  A GPU server has no display;
the equivalent is an offline renderer that snapshots the same content to
PNG via matplotlib(Agg), plus the same counter set as a dict for logging.
"""

from __future__ import annotations

import numpy as np


def hud_counters(slam) -> dict:
    """The Pangolin HUD variables (viewer.cpp:41-48) as a dict."""
    import jax.numpy as jnp

    t = slam.tracking
    m = t.map
    last = t.stats[-1] if t.stats else {}
    return {
        "keyframes": int(jnp.sum(m.kf_valid)),
        "landmarks": int(jnp.sum(m.lm_valid)),
        "tracked_landmarks": last.get("n_tracked", 0),
        "frame_matches": last.get("n_matches", 0),
        "ransac_inliers": last.get("ransac_inliers", 0),
        "frames_processed": len(t.poses),
    }


def draw_matches(img1, xy1, img2, xy2, match_idx, path: str,
                 valid=None, max_lines: int = 200) -> None:
    """Side-by-side correspondence visualization (the reference's
    Matcher::DrawMatches debug helper, matcher.cpp:315-353), written to a
    PNG instead of a cv::imshow window."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    match_idx = np.asarray(match_idx)
    ok = match_idx >= 0
    if valid is not None:
        ok = ok & np.asarray(valid)

    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1]), np.float32)
    canvas[: img1.shape[0], :w1] = img1
    canvas[: img2.shape[0], w1:] = img2

    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255)
    idx = np.nonzero(ok)[0][:max_lines]
    for i in idx:
        j = match_idx[i]
        ax.plot([xy1[i, 0], xy2[j, 0] + w1], [xy1[i, 1], xy2[j, 1]],
                "-", lw=0.5, alpha=0.7)
    ax.scatter(xy1[idx, 0], xy1[idx, 1], s=4, c="#e53e3e")
    ax.scatter(xy2[match_idx[idx], 0] + w1, xy2[match_idx[idx], 1], s=4,
               c="#2b6cb0")
    ax.set_title(f"{len(idx)} matches")
    ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def render_map(slam, path: str, show_covisibility: bool = True,
               min_covis_weight: int = 100) -> None:
    """Top-down (x-z) map snapshot: landmarks, keyframe positions,
    trajectory, strong covisibility edges (mapdrawer.cpp:52-158)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from aslam.models import mapstate as ms
    from aslam.utils import se3
    import jax.numpy as jnp

    m = slam.tracking.map
    fig, ax = plt.subplots(figsize=(8, 8))

    lm_valid = np.asarray(m.lm_valid)
    lms = np.asarray(m.lm_pos)[lm_valid]
    if len(lms):
        ax.scatter(lms[:, 0], lms[:, 2], s=1, c="#888888", label="landmarks")

    # trajectory (camera centers)
    if slam.tracking.poses:
        centers = np.stack([
            np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3]
            for T in slam.tracking.poses
        ])
        ax.plot(centers[:, 0], centers[:, 2], "-", c="#2b6cb0", lw=1,
                label="trajectory")

    kf_valid = np.asarray(m.kf_valid)
    kf_centers = []
    for T in np.asarray(m.kf_T_cw)[kf_valid]:
        kf_centers.append(np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3])
    if kf_centers:
        kfc = np.stack(kf_centers)
        ax.scatter(kfc[:, 0], kfc[:, 2], s=25, c="#e53e3e", marker="s",
                   label="keyframes")
        if show_covisibility and kf_valid.sum() >= 2:
            W = np.asarray(ms.covisibility(m))
            idx = np.nonzero(kf_valid)[0]
            pos = {s: c for s, c in zip(idx, kfc)}
            for a_i, a in enumerate(idx):
                for b in idx[a_i + 1:]:
                    if W[a, b] >= min_covis_weight:
                        ax.plot([pos[a][0], pos[b][0]],
                                [pos[a][2], pos[b][2]],
                                c="#38a169", lw=0.5, alpha=0.6)

    hud = hud_counters(slam)
    ax.set_title(" | ".join(f"{k}: {v}" for k, v in hud.items() if k in
                            ("keyframes", "landmarks", "tracked_landmarks")))
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.axis("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
