"""Session-invoked sharded GBA over the 8k-KF live map on a multi-device
mesh (config-5 contract).

Loads the FINAL session checkpoint written by scripts/finish_10k.py,
resumes it into a DeviceSlam, and has the session's own LoopClosing
invoke the covisibility-placed distributed GN-CG
(loop.post_gba_method = "sharded_gn_cg" -> partitioned_gn_cg_step) over
the process mesh.  Run under the virtual 8-device CPU mesh:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python scripts/sharded_gba_from_checkpoint.py --ckpt ck10k_final

(The same step OOMs on a 1x1 mesh — the whole 8k-KF problem needs ~35 GB
— which is exactly why config 5 shards it.)
"""

from __future__ import annotations

import argparse
import dataclasses as _dc
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="ck10k_final")
    ap.add_argument("--kfs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax

    from aslam.config import (BAConfig, CameraModel, ExtractorConfig,
                                  MapConfig, SystemConfig)
    from aslam.models.device_slam import DeviceSlam

    cam = CameraModel(fx=258.6, fy=258.2, cx=159.3, cy=127.6,
                      width=320, height=240)
    L = max(args.kfs * 64, 16384)
    cfg = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(n_features=512, max_keypoints=512),
        map=MapConfig(max_keyframes=args.kfs, max_landmarks=L),
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192),
        use_loop_closing=True,
    )
    cfg = cfg.replace(loop=_dc.replace(
        cfg.loop, post_gba_method="sharded_gn_cg",
        post_gba_iters=4 * args.steps))
    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].platform}", flush=True)

    dev = DeviceSlam.resume(args.ckpt, cfg, seed=0)
    m = dev.state.m
    n_kfs = int(np.asarray(m.kf_valid).sum())
    print(f"resumed session map: {n_kfs} live KFs, "
          f"{int(np.asarray(m.lm_valid).sum())} landmarks", flush=True)

    from aslam.ops.global_ba import map_chi2

    chi0 = float(map_chi2(m, cfg.camera, cfg.ba))
    t0 = time.time()
    m2 = dev.loop_closing._post_loop_gba(m)
    wall = time.time() - t0
    chi1 = float(map_chi2(m2, cfg.camera, cfg.ba))
    dT = float(np.abs(np.asarray(m2.kf_T_cw) - np.asarray(m.kf_T_cw)).max())
    print(f"session-invoked sharded GN-CG over {len(devs)} devices: "
          f"chi2 {chi0:.1f} -> {chi1:.1f} in {wall:.1f}s "
          f"({args.steps} steps), max|dT|={dT:.2e}", flush=True)
    assert chi1 < chi0, "GBA must reduce chi2"
    if args.out:
        with open(args.out, "a") as f:
            f.write(
                f"\n## r5: session-invoked sharded GBA at {n_kfs} live KFs\n\n"
                f"`sharded_gba_from_checkpoint.py` resumes the 8k-KF "
                f"session checkpoint and the session's LoopClosing runs "
                f"partitioned_gn_cg_step over a {len(devs)}-device mesh: "
                f"chi2 {chi0:.1f} -> {chi1:.1f} in {wall:.1f} s "
                f"({args.steps} GN-CG steps).  The identical invocation "
                f"on a 1x1 mesh OOMs (~35 GB for the unsharded problem) — "
                f"the landmark/keyframe sharding is what makes global "
                f"refinement at this scale fit.\n")
            print(f"appended to {args.out}")


if __name__ == "__main__":
    main()
