"""Keypoint repeatability + descriptor recall/precision under viewpoint
change with homography ground truth.

Equivalent of the reference's `Tests/repeatability_test.cpp` (repeatability
over homography-related views -> `Landmarks_*.csv`) and
`Tests/Recall-Precision.cpp` (`RP_*.csv` curves, plotted by the Matlab
scripts).  Views are generated by warping a textured synthetic frame with
known homographies.

Usage: python scripts/repeatability.py [--csv-prefix out/]
"""

from __future__ import annotations

import argparse

import numpy as np


def warp_image(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse-warp with bilinear sampling (numpy)."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], 0).reshape(3, -1)
    Hinv = np.linalg.inv(H)
    src = Hinv @ pts
    sx = (src[0] / src[2]).reshape(h, w)
    sy = (src[1] / src[2]).reshape(h, w)
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    inside = (sx >= 0) & (sx < w - 1) & (sy >= 0) & (sy < h - 1)
    return np.where(inside, out, 0.0).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv-prefix", default="")
    args = ap.parse_args()

    import jax.numpy as jnp

    from aslam.config import ExtractorConfig
    from aslam.models.extractor import extract_features
    from aslam.utils import evaluation, synthetic

    rng = np.random.default_rng(0)
    # textured base image
    base = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    from aslam.ops.pyramid import gaussian_blur

    base = np.asarray(gaussian_blur(jnp.asarray(base), 7, 1.5)) * 2.0
    base = np.clip(base, 0, 255)

    # 6 homographies of increasing severity (rotation+scale+translation)
    views = []
    for i, ang in enumerate(np.linspace(0.05, 0.35, 6)):
        c, s = np.cos(ang), np.sin(ang)
        H = np.array([
            [c * (1 + 0.03 * i), -s, 20.0 * i],
            [s, c * (1 - 0.02 * i), -10.0 * i],
            [0, 0, 1.0],
        ])
        views.append((H, warp_image(base, H)))

    cfg = ExtractorConfig(n_levels=4)
    f0, _ = extract_features(jnp.asarray(base), cfg)
    xy0 = np.asarray(f0.xy)[np.asarray(f0.valid)]
    d0 = np.asarray(f0.desc)[np.asarray(f0.valid)]

    print("view, repeatability, matchable, recall@50, precision@50")
    rows = []
    for vi, (H, img) in enumerate(views):
        f1, _ = extract_features(jnp.asarray(img), cfg)
        xy1 = np.asarray(f1.xy)[np.asarray(f1.valid)]
        d1 = np.asarray(f1.desc)[np.asarray(f1.valid)]
        proj = np.asarray(evaluation.apply_homography(
            jnp.asarray(H), jnp.asarray(xy0)))
        inside = (proj[:, 0] > 20) & (proj[:, 0] < 620) & \
                 (proj[:, 1] > 20) & (proj[:, 1] < 460)
        if inside.sum() == 0 or len(xy1) == 0:
            continue
        dists = np.linalg.norm(proj[inside, None, :] - xy1[None, :, :], axis=-1)
        rep = (dists.min(1) < 3.0).mean()
        ts, recall, precision = evaluation.recall_precision_curve(
            d0[inside], d1, xy0[inside], xy1, H)
        k50 = np.searchsorted(ts, 50.0)
        rows.append((vi, rep, inside.sum(), recall[k50], precision[k50]))
        print(f"{vi}, {rep:.3f}, {int(inside.sum())}, "
              f"{recall[k50]:.3f}, {precision[k50]:.3f}")
        if args.csv_prefix:
            np.savetxt(
                f"{args.csv_prefix}RP_view{vi}.csv",
                np.stack([ts, recall, precision], 1),
                delimiter=",", header="threshold,recall,precision",
            )
    if args.csv_prefix:
        np.savetxt(f"{args.csv_prefix}Landmarks_repeatability.csv",
                   np.asarray(rows), delimiter=",",
                   header="view,repeatability,n,recall50,precision50")


if __name__ == "__main__":
    main()
