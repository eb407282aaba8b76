"""Finish the 8k-KF config-5 session from its mid-session checkpoint.

The full run (scripts/scale_slam_bench.py --kfs 8192 --seqs 8 --scale 3
--fast --checkpoint-mid) completed sequence 4 and hit keyframe capacity,
but the FINAL single-device sharded-GBA invocation OOM'd (the
distributed GN-CG step needs ~35 GB for the whole 8k-KF problem — it is
built to shard over a mesh, and a 1x1 mesh holds everything on one
chip).  This script:

  1. replays the bench's exact rng stream (trajectories + renders for
     sequences 0..4) to rebuild ground truth and sequence-4 frames;
  2. resumes the checkpoint (state after sequence 3, K~7845) and
     processes sequence 4 to capacity — fps re-measured;
  3. exports the rebuilt trajectory and per-sequence ATE;
  4. saves the FINAL session checkpoint for the virtual-mesh sharded-GBA
     run (scripts/sharded_gba_from_checkpoint.py).

Usage: python scripts/finish_10k.py --ckpt ck10k
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.scale_slam_bench import bounded_walk  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="ck10k")
    ap.add_argument("--kfs", type=int, default=8192)
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--done-seqs", type=int, default=4,
                    help="sequences already in the checkpoint")
    ap.add_argument("--scale", type=float, default=3.0)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--final-ckpt", default="ck10k_final")
    ap.add_argument("--out", default="docs/SCALE_SLAM_10K.md")
    args = ap.parse_args(argv)

    import jax

    from aslam.config import (BAConfig, CameraModel, ExtractorConfig,
                                  MapConfig, SystemConfig)
    import dataclasses as _dc

    from aslam.models.device_slam import DeviceSlam
    from aslam.utils import synthetic_hard as sh
    from aslam.utils import trajectory

    cam = CameraModel(fx=258.6, fy=258.2, cx=159.3, cy=127.6,
                      width=320, height=240)
    L = max(args.kfs * 64, 16384)
    cfg = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(n_features=512, max_keypoints=512),
        map=MapConfig(max_keyframes=args.kfs, max_landmarks=L,
                      lm_cull_every=2, kf_cull_every=2, kf_cull_rounds=1),
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192,
                    local_iters_1=3, local_iters_2=5),
        use_loop_closing=True,
    )
    cfg = cfg.replace(loop=_dc.replace(cfg.loop, post_gba_iters=0))
    print("devices:", jax.devices(), flush=True)

    # --- replay the bench's rng stream exactly (scene draw + per-seq
    # trajectory + render noise), so sequence starts/frames match the
    # original run bit-for-bit
    rng = np.random.default_rng(3)
    sc = args.scale
    scene = sh.room_scene(rng, half_x=2.2 * sc, half_y=1.4,
                          half_z=2.8 * sc,
                          n_panels=max(4, int(4 * sc)),
                          n_posters=max(10, int(10 * sc * sc)))
    n_pf = int(args.kfs / args.seqs * 2.3)

    gt_all = []
    seq_frames = None
    frame_i = 0
    last_C = None
    last_fwd = None
    seq_ranges = []
    for s in range(args.done_seqs + 1):
        if last_C is None:
            start = rng.uniform([-1.2 * sc, -0.1, -1.8 * sc],
                                [1.2 * sc, 0.1, 1.8 * sc])
        else:
            start = np.clip(last_C + rng.normal(0, 0.15, 3),
                            [-1.4 * sc, -0.25, -2.0 * sc],
                            [1.4 * sc, 0.25, 2.0 * sc])
        poses = bounded_walk(n_pf, rng, half_x=1.6 * sc, half_z=2.2 * sc,
                             start=start, start_fwd=last_fwd)
        last_C = -poses[-1][:3, :3].T @ poses[-1][:3, 3]
        last_fwd = poses[-1][2, :3].copy()
        t0 = time.time()
        imgs, deps = [], []
        for i in range(n_pf):
            gain = 1.0 + 0.15 * np.sin(2 * np.pi * (frame_i + i) / 90.0)
            img, dep, _ = sh.render(cam, poses[i], scene, rng=rng,
                                    illum_gain=gain)
            imgs.append(img)
            deps.append(dep)
        print(f"seq {s}: rendered {n_pf} frames [{time.time() - t0:.0f}s]",
              flush=True)
        lo = frame_i
        if s > 0:
            gt_all.append(poses[0])
            gt_all.extend(poses[1:])
        else:
            gt_all.extend(poses)
        frame_i += n_pf
        seq_ranges.append((lo, frame_i))
        if s == args.done_seqs:
            seq_frames = (np.stack(imgs), np.stack(deps), poses)

    # --- resume and process sequence `done_seqs`
    dev = DeviceSlam.resume(args.ckpt, cfg, seed=0,
                            sync_every=8 * args.chunk,
                            ring=max(16 * args.chunk, 256))
    n_before = dev.n_processed
    print(f"resumed: {n_before} frames, K={int(dev.state.n_kfs)}",
          flush=True)
    imgs, deps, poses = seq_frames
    t_seq = time.time()
    ok = dev.new_sequence(imgs[0], deps[0], t=n_before * 0.033)
    print(f"seq {args.done_seqs}: re-anchored={ok}", flush=True)
    n_done = 1
    for c0 in range(1, n_pf, args.chunk):
        c1 = min(c0 + args.chunk, n_pf)
        dev.process_chunk(imgs[c0:c1], deps[c0:c1],
                          ts=[(n_before + c0 + j) * 0.033
                              for j in range(c1 - c0)])
        n_done += c1 - c0
        if dev.last_n_kfs >= cfg.map.max_keyframes - 2:
            break
    n_kfs = int(dev.state.n_kfs)
    dt = time.time() - t_seq
    print(f"seq {args.done_seqs}: {n_done} frames in {dt:.1f}s "
          f"({n_done / dt:.1f} fps), K={n_kfs}", flush=True)

    t_fin = time.time()
    traj, stats = dev.finish()
    print(f"finish/flush {time.time() - t_fin:.1f}s "
          f"({len(traj)} poses)", flush=True)
    dev.save(args.final_ckpt)
    print(f"saved final session checkpoint -> {args.final_ckpt}",
          flush=True)

    rebuilt = dev.rebuilt_trajectory()
    n = min(len(rebuilt), len(gt_all))
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_all[:n]])
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in rebuilt[:n]])
    rows = []
    for s, (lo, hi) in enumerate(seq_ranges):
        hi = min(hi, n)
        if lo >= n:
            break
        ate = trajectory.ate_rmse(est_c[lo:hi], gt_c[lo:hi])
        rows.append((s, hi - lo, ate))
        print(f"seq {s}: ATE {ate:.4f} m over {hi - lo} frames", flush=True)
    ate_all = trajectory.ate_rmse(est_c, gt_c)
    print(f"overall ATE: {ate_all:.4f} m over {n} frames, K={n_kfs}",
          flush=True)

    if args.out:
        with open(args.out, "w") as f:
            f.write(
                "# Config-5 device session: 8192 LIVE keyframes\n\n"
                "`scale_slam_bench --kfs 8192 --seqs 8 --scale 3 --fast "
                "--checkpoint-mid` + `finish_10k.py` (the capacity "
                "sequence resumed from the mid-session checkpoint).  "
                "320x240/512 kp, 3x room, loop closing ON "
                "(pose-graph corrections; post-GBA deferred to the "
                "virtual-mesh sharded run).\n\n"
                f"Sequence 4: {n_done} frames to **{n_kfs}** live keyframes "
                f"(capacity) in {dt:.0f} s = {n_done / dt:.1f} frames/s on "
                f"{jax.devices()[0].device_kind}.\n\n"
                "## Accuracy (rebuilt trajectory vs ground truth)\n\n"
                "| sequence | frames | ATE (m) |\n|---|---|---|\n")
            for s, nn, ate in rows:
                f.write(f"| {s} | {nn} | {ate:.4f} |\n")
            f.write(f"| **all** | {n} | **{ate_all:.4f}** |\n\n"
                    "Final session checkpoint: the sharded-GBA run "
                    "(docs/PARTITION.md r5 section) resumes it on the "
                    "8-virtual-device mesh.\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
