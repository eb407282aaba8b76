"""Config-5 scale benchmark: global BA over a 10k-keyframe map.

Builds a synthetic corridor map entirely in vectorized numpy (10k+ KFs,
sliding landmark visibility windows — the covisibility structure of a
long multi-sequence trajectory), then measures chunked global-BA sweep
throughput on the available device.

Usage: python scripts/scale_bench.py [--kfs 10240] [--feats 256]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=10240)
    ap.add_argument("--feats", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--sweeps", type=int, default=6)
    ap.add_argument("--method", choices=["sweep", "gn_cg"], default="sweep")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from aslam.config import SystemConfig, CameraModel, MapConfig, \
        ExtractorConfig
    from aslam.ops import global_ba
    from aslam.workloads import build_corridor_map

    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                      width=640, height=480)
    cfg = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(max_keypoints=args.feats),
        map=MapConfig(max_keyframes=args.kfs,
                      max_landmarks=args.kfs * (args.feats // 4) + args.feats),
    )
    print("devices:", jax.devices(), flush=True)
    print(f"building {args.kfs}-KF map...", flush=True)
    m, T_true, lm_true = build_corridor_map(cfg, args.kfs, args.feats)
    E = int(np.asarray(m.kf_kp_valid).sum())
    print(f"map: K={args.kfs} L={m.lm_pos.shape[0]} E={E}", flush=True)

    if args.method == "gn_cg":
        sweep = lambda mm: global_ba.gn_cg_step(  # noqa: E731
            mm, cam, cfg.ba, robust=True, cg_iters=32, lam=1e-3,
            kf_chunk=args.chunk)
    else:
        sweep = lambda mm: global_ba.ba_sweep_chunked(  # noqa: E731
            mm, cam, cfg.ba, robust=True, lam=1e-2, kf_chunk=args.chunk)
    t0 = time.time()
    m2, stats = sweep(m)
    jax.block_until_ready(m2.kf_T_cw)
    print(f"compile+first sweep: {time.time()-t0:.1f}s "
          f"chi2={float(stats.chi2):.1f}", flush=True)

    t0 = time.time()
    mm = m2
    for _ in range(args.sweeps):
        mm, stats = sweep(mm)
        jax.block_until_ready(mm.kf_T_cw)
    dt = time.time() - t0
    print(f"{args.sweeps} sweeps in {dt:.2f}s -> "
          f"{args.sweeps/dt:.2f} sweeps/s ({E*args.sweeps/dt/1e6:.1f} M "
          f"edge-updates/s), final chi2={float(stats.chi2):.1f}", flush=True)

    # accuracy: poses should approach truth
    errs = np.linalg.norm(
        np.asarray(mm.kf_T_cw)[:, :3, 3] - T_true[:, :3, 3], axis=1)
    print(f"pose err after: mean {errs.mean()*1000:.2f} mm "
          f"max {errs.max()*1000:.2f} mm", flush=True)


if __name__ == "__main__":
    main()
