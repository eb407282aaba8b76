"""Full-SLAM throughput: the device-resident slam_step (tracking + local
map + keyframe insertion) streamed over a synthetic sequence.

Complements bench.py (config-1 VO fps, the headline metric) with the
config-2 shape: map tracking against a growing keyframe/landmark database.

Usage: python scripts/slam_bench.py [--frames 48]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=65)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--gicp", action="store_true",
                    help="ADAPTIVE_RICP policy (fused lax.cond GICP "
                         "escalation) instead of ADAPTIVE_RBA")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from aslam.config import SystemConfig, CameraModel
    from aslam.models.device_slam import DeviceSlam
    from aslam.utils import synthetic

    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                      width=640, height=480)
    cfg = SystemConfig(camera=cam, use_gicp=args.gicp)
    print("devices:", jax.devices(), "gicp:", args.gicp, flush=True)
    print("rendering...", flush=True)
    imgs, depths, poses, _ = synthetic.make_sequence(
        n_frames=args.frames, n_points=1500, cam=cam, seed=7)
    imgs_u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    depths_u16 = np.clip(depths / cam.depth_factor, 0, 65535).astype(np.uint16)

    slam = DeviceSlam(cfg, sync_every=10**9)  # mapping flushed manually
    t0 = time.time()
    slam.process(imgs_u8[0], depths_u16[0], 0.0)
    slam.process(imgs_u8[1], depths_u16[1], 0.033)
    jax.block_until_ready(slam.state.m.lm_pos)
    print(f"compile+init {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    for i in range(2, args.frames):
        slam.process(imgs_u8[i], depths_u16[i], i * 0.033)
        jax.block_until_ready(slam.state.last_frame.T_cw)
    dt = time.time() - t0
    n = args.frames - 2
    print(f"slam tracking (stream, 1 dispatch/frame): {n} frames in "
          f"{dt:.3f}s -> {n/dt:.1f} fps", flush=True)

    # chunked: lax.scan of slam_step, one dispatch per chunk (device_slam.
    # slam_scan; bit-identical to streaming, test-enforced)
    chunk = args.chunk
    slam2 = DeviceSlam(cfg, sync_every=10**9)
    t0 = time.time()
    # warmup scans `chunk` frames (frame 0 is the init step) so the timed
    # chunks reuse the same compiled scan length
    slam2.process_chunk(imgs_u8[:chunk + 1], depths_u16[:chunk + 1])
    jax.block_until_ready(slam2.state.last_frame.T_cw)
    print(f"chunked compile+warmup {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    n = 0
    for lo in range(chunk + 1, args.frames - chunk + 1, chunk):
        hi = min(lo + chunk, args.frames)
        if hi - lo < 2:
            break
        slam2.process_chunk(imgs_u8[lo:hi], depths_u16[lo:hi])
        jax.block_until_ready(slam2.state.last_frame.T_cw)
        n += hi - lo
    if n:
        dt = time.time() - t0
        print(f"slam tracking (chunked, {chunk} frames/dispatch): {n} "
              f"frames in {dt:.3f}s -> {n/dt:.1f} fps", flush=True)

    print(f"keyframes inserted on device: {int(slam.state.n_kfs)}",
          flush=True)


if __name__ == "__main__":
    main()
