"""Accuracy race: the batched engine vs a faithful reference-semantics CPU baseline.

The BASELINE north star is "ATE <= reference" on real RGB-D sequences.  No
TUM/ICL data exists in this environment and the reference's C++ stack
cannot be built here, so this script makes the claim falsifiable the only
way available: both estimators consume IDENTICAL inputs — hard synthetic
sequences (textured surfaces, fr1-strength distortion, Khoshelham depth
noise sigma=0.01 z^2, rolling illumination, 200-frame loops; see
utils/synthetic_hard.py) — through the SAME feature front-end, and race:

  ref-cpu  : sequential 200-iteration Mahalanobis RANSAC with <=20 inner
             refits and early exit + g2o-schedule motion-only BA, exact
             reference semantics incl. quirks (baselines/refcpu.py, cites
             /root/reference/Odometry/ransac.cpp:155-431, pnpsolver.cpp)
  aslam-vo : the production fused rba_step (parallel-hypothesis RANSAC +
             batched 4x10 pose BA), models/odometry.py
  aslam-slam (loop seqs): full system incl. local mapping + loop closing +
             retro-corrected export (models/system.py)

Output: a markdown table (stdout + results/ACCURACY.md) of ATE RMSE per
sequence.  Run on the CPU or the GPU; the sequences are deterministic per seed.

Usage:
  JAX_PLATFORMS=cpu python scripts/accuracy_compare.py \
      --frames 200 --seqs loop:0,loop:1,sweep:2,sweep:3 [--small] [--slam]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aslam.baselines import refcpu  # noqa: E402
from aslam.config import TUM_FR1, SystemConfig, small_config  # noqa: E402
from aslam.models import frame as frame_mod  # noqa: E402
from aslam.models.extractor import init_adaptive_state  # noqa: E402
from aslam.ops import matching  # noqa: E402
from aslam.utils import synthetic_hard as sh  # noqa: E402
from aslam.utils import trajectory  # noqa: E402


def centers_of(T_cw: np.ndarray) -> np.ndarray:
    return np.stack([np.linalg.inv(T)[:3, 3] for T in T_cw])


def extract_frames(cfg: SystemConfig, imgs, depths):
    """Shared front-end: FrameData per frame (identical inputs contract)."""
    st = init_adaptive_state(cfg.extractor)
    frames = []
    for i in range(len(imgs)):
        f, st = frame_mod.make_frame(jnp.asarray(imgs[i]),
                                     jnp.asarray(depths[i]), cfg, st)
        frames.append(f)
    return frames


def run_ref_cpu(cfg: SystemConfig, frames, seed: int = 0) -> np.ndarray:
    """Reference-policy VO (ADAPTIVE_RBA): KnnMatch(0.9) -> sequential
    RANSAC -> compose -> g2o-schedule pose BA on the carried VO landmarks
    (tracking.cpp:136-229, odometry.cpp:105-116)."""
    cam = cfg.camera
    rs = refcpu.RefRansac(cam, seed=seed)
    poses = [np.eye(4)]
    for i in range(1, len(frames)):
        f1, f2 = frames[i - 1], frames[i]
        m = matching.knn_ratio_match(
            f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
            ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high),
        )
        m = matching.resolve_duplicates(m, f2.feat.desc.shape[0])
        valid = np.asarray(m.valid)
        tgt = np.asarray(m.target_idx)
        dist = np.asarray(m.distance)
        has1 = np.asarray(f1.has_depth)
        has2 = np.asarray(f2.has_depth)
        sel = np.nonzero(valid & has1 & has2[np.maximum(tgt, 0)])[0]
        p1 = np.asarray(f1.p3d)[sel]
        p2 = np.asarray(f2.p3d)[tgt[sel]]
        T12, inl, rmse, ok = rs.iterate(p1, p2, dist[sel])
        T_cw1 = poses[-1]
        T_cw2 = T12 @ T_cw1

        # VO landmarks: frame-1 backprojections lifted to world at the
        # current estimate (UpdateLastFrame, tracking.cpp:136-190); the
        # frame-2 observations are the matched keypoints
        pts_w = p1 @ np.linalg.inv(T_cw1)[:3, :3].T \
            + np.linalg.inv(T_cw1)[:3, 3]
        uv2 = np.asarray(f2.xy_und)[tgt[sel]]
        ur2 = np.asarray(f2.ur)[tgt[sel]]
        T_cw2, _, n_inl = refcpu.pose_only_ba(T_cw2, pts_w, uv2, ur2, cam)
        poses.append(T_cw2)
    return np.stack(poses)


def run_aslam_vo(cfg: SystemConfig, frames, seed: int = 0) -> np.ndarray:
    """Production fused VO on the same FrameData sequence."""
    from aslam.models.odometry import rba_step

    key = jax.random.PRNGKey(seed)
    poses = [np.eye(4)]
    f_prev = frame_mod.with_pose(frames[0], jnp.eye(4))
    for i in range(1, len(frames)):
        key, sub = jax.random.split(key)
        res = rba_step(f_prev, frames[i], sub, cfg)
        f_prev = frame_mod.with_pose(frames[i], res.T_cw2)
        poses.append(np.asarray(res.T_cw2))
    return np.stack(poses)


def run_aslam_slam(cfg: SystemConfig, imgs, depths, loop: bool) -> np.ndarray:
    from aslam.models.system import SlamSystem

    scfg = cfg.replace(use_loop_closing=loop)
    slam = SlamSystem(scfg)
    for i in range(len(imgs)):
        slam.process(imgs[i], depths[i], t=i * 0.033)
    return slam.rebuilt_trajectory()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seqs", default="loop:0,loop:1,sweep:2,sweep:3")
    ap.add_argument("--small", action="store_true",
                    help="320x240 camera (fast CPU runs)")
    ap.add_argument("--slam", action="store_true",
                    help="also run the full SLAM system per sequence")
    ap.add_argument("--out", default="results/ACCURACY.md")
    args = ap.parse_args(argv)

    if args.small:
        cfg = small_config()
        cam = dataclasses.replace(
            cfg.camera, k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026,
            k3=1.1633)
        cfg = cfg.replace(camera=cam)
    else:
        cfg = SystemConfig(camera=TUM_FR1)

    rows = []
    for spec in args.seqs.split(","):
        kind, seed_s = spec.split(":")
        seed = int(seed_s)
        t0 = time.time()
        imgs, depths, gt = sh.make_hard_sequence(
            cfg.camera, kind=kind, n_frames=args.frames, seed=seed)
        t_render = time.time() - t0
        gt_c = centers_of(gt)

        t0 = time.time()
        frames = extract_frames(cfg, imgs, depths)
        jax.block_until_ready(frames[-1].feat.desc)
        t_extract = time.time() - t0

        t0 = time.time()
        ref_poses = run_ref_cpu(cfg, frames, seed=seed)
        t_ref = time.time() - t0
        ate_ref = trajectory.ate_rmse(centers_of(ref_poses), gt_c)

        t0 = time.time()
        vo_poses = run_aslam_vo(cfg, frames, seed=seed)
        t_vo = time.time() - t0
        ate_vo = trajectory.ate_rmse(centers_of(vo_poses), gt_c)

        row = {
            "seq": f"{kind}:{seed}", "frames": args.frames,
            "ate_ref_cpu": ate_ref, "ate_aslam_vo": ate_vo,
            "t_ref_s": t_ref, "t_vo_s": t_vo,
        }
        if args.slam:
            t0 = time.time()
            slam_poses = run_aslam_slam(cfg, imgs, depths, loop=kind == "loop")
            row["ate_aslam_slam"] = trajectory.ate_rmse(
                centers_of(slam_poses), gt_c)
            row["t_slam_s"] = time.time() - t0
        rows.append(row)
        print(f"[{row['seq']}] render {t_render:.0f}s extract {t_extract:.0f}s | "
              f"ref-cpu ATE {ate_ref:.4f} m ({t_ref:.0f}s) | "
              f"aslam-vo ATE {ate_vo:.4f} m ({t_vo:.0f}s)"
              + (f" | aslam-slam ATE {row['ate_aslam_slam']:.4f} m"
                 if args.slam else ""), flush=True)

    # markdown table
    hdr = ("| sequence | frames | ref-cpu ATE (m) | aslam-vo ATE (m) | "
           + ("aslam-slam ATE (m) | " if args.slam else "")
           + "vo vs ref |")
    sep = "|---" * (5 + (1 if args.slam else 0)) + "|"
    lines = [hdr, sep]
    for r in rows:
        ratio = r["ate_aslam_vo"] / max(r["ate_ref_cpu"], 1e-9)
        line = (f"| {r['seq']} | {r['frames']} | {r['ate_ref_cpu']:.4f} | "
                f"{r['ate_aslam_vo']:.4f} | "
                + (f"{r['ate_aslam_slam']:.4f} | " if args.slam else "")
                + f"{ratio:.2f}x |")
        lines.append(line)
    table = "\n".join(lines)
    print(table)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# Accuracy: aslam vs reference-semantics CPU baseline\n\n"
                "Identical inputs (shared front-end), hard synthetic suite "
                "(textured surfaces, fr1 distortion, Khoshelham depth noise, "
                "rolling illumination).  Generated by "
                "scripts/accuracy_compare.py.\n\n" + table + "\n")
    return rows


if __name__ == "__main__":
    main()
