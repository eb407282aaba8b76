"""Per-stage device-time profile of the tracking step.

Times each stage of make_frame + rba_step with N chained iterations inside
one jitted lax.fori_loop — one dispatch, one barrier — so the per-call
dispatch cost cancels out and the number is device time.
Every iteration depends on the loop carry (perturbed inputs / folded keys)
to defeat loop-invariant code motion.

Usage: python scripts/profile_track.py [--iters 50]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--stages", default="front,knn,ransac,mba,full")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from aslam.config import CameraModel, SystemConfig
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.models.odometry import rba_step
    from aslam.ops import ba, matching, ransac
    from aslam.utils import synthetic
    from aslam.utils.se3 import T_inv, transform_points

    print("devices:", jax.devices())
    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                      width=640, height=480)
    cfg = SystemConfig(camera=cam)
    N = args.iters

    imgs, depths, _, _ = synthetic.make_sequence(
        n_frames=2, n_points=1500, cam=cam, seed=5)
    img0 = jnp.asarray(np.clip(imgs[0], 0, 255).astype(np.uint8))
    dep0 = jnp.asarray(
        np.clip(depths[0] / cam.depth_factor, 0, 65535).astype(np.uint16))
    img1 = jnp.asarray(np.clip(imgs[1], 0, 255).astype(np.uint8))
    dep1 = jnp.asarray(
        np.clip(depths[1] / cam.depth_factor, 0, 65535).astype(np.uint16))

    stages_wanted = {
        {"front": "make_frame", "knn": "knn", "ransac": "ransac",
         "mba": "motion-only", "full": "rba_step"}[s]
        for s in args.stages.split(",")}
    state = init_adaptive_state(cfg.extractor)
    f1, state = frame_mod.make_frame(img0, dep0, cfg, state)
    f1 = frame_mod.with_pose(f1, jnp.eye(4))
    f2, state = frame_mod.make_frame(img1, dep1, cfg, state)
    key0 = jax.random.PRNGKey(0)

    def timed(name, fn, *inputs):
        """fn(carry, i, *inputs) -> scalar carry; N chained iters."""
        @jax.jit
        def run(c0, *ins):
            return lax.fori_loop(
                0, N, lambda i, c: fn(c, i, *ins), c0)

        if name.split()[0].rstrip(':') not in stages_wanted:
            return None
        r = run(jnp.float32(0.0), *inputs)          # compile + warm
        jax.block_until_ready(r)
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            r = run(jnp.float32(0.0), *inputs)
            _ = float(r)
            best = min(best, time.perf_counter() - t0)
        print(f"{name:22s} {best / N * 1e6:9.1f} us/iter "
              f"({best * 1e3:7.2f} ms / {N})")
        return best / N

    # --- full make_frame (extraction front-end) ---
    def front(c, i, img, dep, grid):
        # i-dependent input so XLA cannot hoist the body out of the loop
        im = img ^ (i & 1).astype(jnp.uint8)
        fd, new_grid = frame_mod._make_frame_impl(
            im, dep, grid + (i % 2).astype(jnp.float32) * 1e-6, cfg, 480, 640)
        return (c + jnp.sum(fd.feat.xy) * 1e-9 + jnp.sum(new_grid) * 1e-9
                + jnp.sum(fd.feat.desc).astype(jnp.float32) * 1e-12
                + jnp.sum(fd.feat.angle) * 1e-9 + jnp.sum(fd.p3d) * 1e-12)

    timed("make_frame (front-end)", front, img1, dep1, state.grid_thresholds)

    # --- knn match ---
    def knn(c, i, d1, v1, d2, v2):
        d1x = d1 ^ (i.astype(jnp.uint32) & 1)
        m = matching.knn_ratio_match(
            d1x, v1, d2, v2, ratio=cfg.matcher.ratio_frame,
            max_dist=float(cfg.matcher.th_high))
        m = matching.resolve_duplicates(m, d2.shape[0])
        return c + jnp.sum(m.valid) * 1e-9

    timed("knn match + dedup", knn,
          f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid)

    # --- RANSAC ---
    m0 = matching.knn_ratio_match(
        f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high))
    m0 = matching.resolve_duplicates(m0, f2.feat.desc.shape[0])
    tgt = jnp.maximum(m0.target_idx, 0)
    p1 = f1.p3d
    p2 = f2.p3d[tgt]
    pv = m0.valid & f1.has_depth & f2.has_depth[tgt]

    def rans(c, i, p1, p2, pv):
        k = jax.random.fold_in(key0, i)  # per-iter key: no hoisting
        res = ransac.ransac_align(p1, p2, pv, k, cfg.ransac, cam)
        return c + res.rmse * 1e-9

    timed("ransac (256 hyp)", rans, p1, p2, pv)

    # --- motion-only BA ---
    res0 = ransac.ransac_align(p1, p2, pv, key0, cfg.ransac, cam)
    pts_w = transform_points(T_inv(f1.T_cw), p1)
    T0 = res0.T12 @ f1.T_cw

    def mba(c, i, T0, pts_w, uv, ur, z, inl):
        r = ba.pose_only_ba(
            T0 + (i % 2).astype(jnp.float32) * 1e-9,
            pts_w, uv, ur, z, inl, cam, cfg.ba)
        return c + r.T_cw[0, 3] * 1e-9

    timed("motion-only BA (4x10)", mba, T0, pts_w, f2.xy_und[tgt],
          f2.ur[tgt], f2.depth[tgt], res0.inliers & pv)

    # --- full rba_step ---
    def full(c, i, f1d, f2d):
        k = jax.random.fold_in(key0, i)
        f1p = f1d._replace(
            T_cw=f1d.T_cw + (i % 2).astype(jnp.float32) * 1e-9)
        r = rba_step(f1p, f2d, k, cfg)
        return c + r.T_cw2[0, 3] * 1e-9

    timed("rba_step (match+RANSAC+BA)", full, f1, f2)


if __name__ == "__main__":
    main()
