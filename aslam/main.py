"""CLI driver: run the SLAM system on a TUM RGB-D sequence.

Replaces `main.cpp` (reference driver: dataset loop, subsystem
construction, shutdown, trajectory export, main.cpp:25-143) — but where
the reference hardcodes dataset paths and algorithm choices as
compile-time constants (main.cpp:17-23), everything here is a CLI flag
over the typed config tree.

Usage:
  python -m aslam.main --dataset /data/rgbd_dataset_freiburg1_xyz \
      --camera fr1 --mode slam --out-dir results/
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from aslam import config as cfg_mod
from aslam.config import SystemConfig


CAMERAS = {
    "fr1": cfg_mod.TUM_FR1,
    "fr2": cfg_mod.TUM_FR2,
    "fr3": cfg_mod.TUM_FR3,
    "icl": cfg_mod.ICL_NUIM,
}


def build_config(args) -> SystemConfig:
    cfg = SystemConfig(camera=CAMERAS[args.camera])
    if args.mode == "vo":
        pass
    elif args.mode == "slam":
        pass
    elif args.mode == "slam+loop":
        cfg = cfg.replace(use_loop_closing=True)
    elif args.mode == "slam+gicp":
        cfg = cfg.replace(use_gicp=True, use_loop_closing=True)
    if args.detector != "FAST" or args.descriptor != "ORB":
        from dataclasses import replace as dc_replace

        from aslam.ops import desc as desc_ops

        if not desc_ops.is_binary(args.descriptor) and args.mode != "vo":
            raise SystemExit(
                f"--descriptor {args.descriptor} is a float (L2) family; the "
                "map/BoW schema is binary — use it with --mode vo, or pick a "
                "binary descriptor (ORB, BRIEF, FREAK, LATCH) for SLAM modes"
            )
        cfg = cfg.replace(extractor=dc_replace(
            cfg.extractor, detector=args.detector, descriptor=args.descriptor))
    if getattr(args, "pose_prior", None) is not None:
        from dataclasses import replace as dc_replace

        cfg = cfg.replace(tracking=dc_replace(
            cfg.tracking, pose_prior_weight=args.pose_prior))
    if getattr(args, "chain_prior", None) is not None:
        from dataclasses import replace as dc_replace

        cfg = cfg.replace(ba=dc_replace(
            cfg.ba, chain_prior_weight=args.chain_prior))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description="RGB-D SLAM on an accelerator")
    ap.add_argument("--dataset", required=True,
                    help="TUM sequence dir with associations.txt")
    ap.add_argument("--camera", choices=sorted(CAMERAS), default="fr1")
    ap.add_argument("--mode", choices=["vo", "slam", "slam+loop", "slam+gicp"],
                    default="slam")
    ap.add_argument("--engine", choices=["host", "device"], default="host",
                    help="host: step-by-step Tracking (readable reference); "
                         "device: fused slam_step with zero per-frame host "
                         "sync (the production path)")
    ap.add_argument("--detector", default="FAST",
                    help="FAST|GFTT|HARRIS|DOG|HESSIAN|STAR "
                         "(+aliases ORB, SIFT, SURF, BRISK, STAR/CENSURE)")
    ap.add_argument("--descriptor", default="ORB",
                    help="ORB|BRIEF|FREAK|LATCH (binary, all modes) or "
                         "SIFT/SURF (float, --mode vo only)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per device dispatch (device engine only): "
                         "chunks are lax.scan-chained on device (slam_scan),"
                         " equivalent to streaming with one dispatch and "
                         "one host sync per chunk")
    ap.add_argument("--pose-prior", type=float, default=None,
                    help="odometry motion-prior information in the "
                         "local-map pose refinement (1/m^2; default from "
                         "config; 0 = reference-style unconstrained "
                         "re-solve — see docs/FUSION_STUDY.md)")
    ap.add_argument("--chain-prior", type=float, default=None,
                    help="odometry-chain regularizer information in "
                         "local/global BA (1/m^2; 0 disables)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--checkpoint", default="",
                    help="save map checkpoint here at the end")
    ap.add_argument("--resume", default="", help="load map checkpoint")
    ap.add_argument("--render-map", action="store_true")
    ap.add_argument("--export-cloud", action="store_true",
                    help="fuse depth maps into results/map.ply")
    ap.add_argument("--viewer", type=int, default=-1, metavar="PORT",
                    help="serve a live web map viewer on this port "
                         "(0 = auto-pick); replaces the Pangolin thread")
    ap.add_argument("--viewer-every", type=int, default=10,
                    help="publish a snapshot every N frames (one device "
                         "read per publish)")
    args = ap.parse_args(argv)

    from aslam.utils.dataset import TumSequence
    from aslam.utils.metrics import Metrics

    cfg = build_config(args)
    seq = TumSequence(args.dataset, depth_factor=cfg.camera.depth_factor)
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    metrics = Metrics()

    os.makedirs(args.out_dir, exist_ok=True)

    if args.mode == "vo":
        from aslam.models.vo import VisualOdometry

        engine = VisualOdometry(cfg)
        for i in range(n):
            t, img, depth = seq[i]
            with metrics.timer("track"):
                engine.process(img, depth, t)
            metrics.count("frames")
        poses, timestamps = engine.poses, engine.timestamps
        from aslam.utils.trajectory import save_tum_trajectory

        save_tum_trajectory(os.path.join(args.out_dir, "CameraTrajectory.txt"),
                            np.asarray(timestamps), np.stack(poses))
    elif args.engine == "device":
        from aslam.models.device_slam import DeviceSlam
        from aslam.utils.trajectory import save_tum_trajectory

        slam = DeviceSlam(cfg)
        t0 = time.time()
        if args.chunk > 1 and n:
            # bootstrap on the first frame alone, so that every later full
            # chunk has the same length and reuses one compiled scan
            t, img, depth = seq[0]
            slam.process(img, depth, t)
            metrics.count("frames")
            lo = 1
            while lo < n:
                hi = min(lo + args.chunk, n)
                if hi - lo < args.chunk:
                    # tail shorter than the compiled scan length: stream it
                    for i in range(lo, hi):
                        t, img, depth = seq[i]
                        with metrics.timer("track"):
                            slam.process(img, depth, t)
                        metrics.count("frames")
                else:
                    ts, imgs, depths = zip(*(seq[i] for i in range(lo, hi)))
                    with metrics.timer("track"):
                        slam.process_chunk(np.stack(imgs), np.stack(depths),
                                           list(ts))
                    metrics.count("frames", hi - lo)
                lo = hi
        else:
            for i in range(n):
                t, img, depth = seq[i]
                with metrics.timer("track"):
                    slam.process(img, depth, t)
                metrics.count("frames")
        traj, stats = slam.finish()
        save_tum_trajectory(
            os.path.join(args.out_dir, "CameraTrajectory.txt"),
            np.asarray(slam.timestamps), traj)
        print(f"{n} frames, {int(slam.state.n_kfs)} keyframes, "
              f"{(time.time() - t0) / max(n, 1) * 1e3:.1f} ms/frame")
    else:
        from aslam.models.system import SlamSystem
        from aslam.utils import checkpoint as ckpt

        slam = SlamSystem(cfg)
        if args.resume:
            ckpt.load_system(args.resume, slam)
        viewer = None
        if args.viewer >= 0:
            from aslam.utils.viewer import hud_counters
            from aslam.utils.webviewer import WebViewer

            viewer = WebViewer(port=args.viewer)
            print(f"live viewer: {viewer.url}", flush=True)
        t0 = time.time()
        for i in range(n):
            t, img, depth = seq[i]
            with metrics.timer("track"):
                slam.process(img, depth, t)
            metrics.count("frames")
            if viewer is not None and i % max(args.viewer_every, 1) == 0:
                viewer.update(
                    slam.tracking.map,
                    traj=np.stack(slam.tracking.poses),
                    stats=dict(hud_counters(slam), frame=i),
                )
            if i % 50 == 0:
                mean_ms = 1e3 * (time.time() - t0) / max(i, 1)
                print(f"[{i}/{n}] mean {mean_ms:.1f} ms/frame", flush=True)
        # exports (main.cpp:124-126)
        slam.save_trajectory(os.path.join(args.out_dir, "CameraTrajectory.txt"))
        slam.save_keyframe_trajectory(
            os.path.join(args.out_dir, "KeyFrameTrajectory.txt"))
        slam.save_observation_histogram(
            os.path.join(args.out_dir, "Histogram.csv"))
        if args.checkpoint:
            ckpt.save_system(args.checkpoint, slam)
        if args.render_map:
            from aslam.utils.viewer import render_map

            render_map(slam, os.path.join(args.out_dir, "map.png"))
        if args.export_cloud:
            from aslam.utils.pointcloud import export_dense_map

            n_pts = export_dense_map(
                slam, seq, os.path.join(args.out_dir, "map.ply"))
            print(f"dense map: {n_pts} points -> map.ply")

    metrics.dump(os.path.join(args.out_dir, "metrics.json"))
    print(json.dumps(metrics.summary()["timers"], indent=2))


if __name__ == "__main__":
    main()
