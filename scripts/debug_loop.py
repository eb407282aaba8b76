"""Isolate the SLAM-on-loop ATE regression: run one hard loop sequence
through the full system with loop closing ON vs OFF, dumping per-event
diagnostics (loop detections, corrections, per-frame error spikes)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aslam.config import TUM_FR1, SystemConfig, small_config  # noqa: E402
from aslam.utils import synthetic_hard as sh  # noqa: E402
from aslam.utils import trajectory  # noqa: E402


def centers_of(T_cw):
    return np.stack([np.linalg.inv(T)[:3, 3] for T in T_cw])


def run(cfg, imgs, depths, gt_c, gt_T, loop: bool, tag: str,
        no_fuse=False, no_lba=False, no_cull=False, quiet=False):
    from aslam.models import localmapping as lmod
    from aslam.models import mapstate as ms
    from aslam.models.system import SlamSystem

    # ablation monkeypatches (debug only)
    orig_fuse = lmod.fuse_landmarks
    orig_ba = lmod.lba.local_ba
    orig_cull = ms.keyframe_culling
    if no_fuse:
        lmod.fuse_landmarks = lambda m, slot, cfg: m
    if no_lba:
        lmod.lba.local_ba = lambda prob, cam, cfg: (prob, None)
    if no_cull:
        class _NoCull:
            culled = False
        ms.keyframe_culling = lambda m, slot, cfg: (m, _NoCull())

    scfg = cfg.replace(use_loop_closing=loop)
    slam = SlamSystem(scfg)
    if slam.loop_closing is not None:
        slam.loop_closing.verbose = True
    for i in range(len(imgs)):
        T, info = slam.process(imgs[i], depths[i], t=i * 0.033)
        if quiet:
            continue
        # per-frame drift: translation error of T vs gt (relative to frame 0)
        err = np.linalg.norm(np.linalg.inv(T)[:3, 3]
                             - np.linalg.inv(gt_T[i])[:3, 3])
        print(f"  [{tag}] f{i:03d} st={slam.tracking.state:5s} "
              f"trk={info.get('n_tracked', -1):4d} "
              f"mat={info.get('n_matches', -1):4d} "
              f"inl={info.get('ransac_inliers', -1):4d} "
              f"kf={int(info.get('new_kf', False))} "
              f"err={err:.3f}"
              + (" RELOC" if info.get("relocalized") else "")
              + (" MM" if info.get("motion_model") else ""), flush=True)
    frozen = np.stack(slam.tracking.poses)
    rebuilt = slam.rebuilt_trajectory()
    ate_frozen = trajectory.ate_rmse(centers_of(frozen), gt_c)
    ate_rebuilt = trajectory.ate_rmse(centers_of(rebuilt), gt_c)
    print(f"[{tag}] ATE frozen={ate_frozen:.4f} rebuilt={ate_rebuilt:.4f} "
          f"kfs={slam.tracking.n_kfs}")
    if slam.loop_closing is not None:
        print(f"  lc.loops = {slam.loop_closing.loops}")
    lmod.fuse_landmarks = orig_fuse
    lmod.lba.local_ba = orig_ba
    ms.keyframe_culling = orig_cull
    return frozen, rebuilt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    if args.small:
        cfg = small_config()
        cam = dataclasses.replace(
            cfg.camera, k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026,
            k3=1.1633)
        cfg = cfg.replace(camera=cam)
    else:
        cfg = SystemConfig(camera=TUM_FR1)

    imgs, depths, gt = sh.make_hard_sequence(
        cfg.camera, kind="loop", n_frames=args.frames, seed=args.seed)
    gt_c = centers_of(gt)
    print(f"rendered {args.frames} frames")

    run(cfg, imgs, depths, gt_c, gt, loop=False, tag="slam-noloop", quiet=True)
    run(cfg, imgs, depths, gt_c, gt, loop=False, tag="slam-nofuse",
        no_fuse=True, quiet=True)
    run(cfg, imgs, depths, gt_c, gt, loop=False, tag="slam-nolba",
        no_lba=True, quiet=True)
    run(cfg, imgs, depths, gt_c, gt, loop=False, tag="slam-nocull",
        no_cull=True, quiet=True)
    run(cfg, imgs, depths, gt_c, gt, loop=False, tag="slam-bare",
        no_fuse=True, no_lba=True, no_cull=True, quiet=True)


if __name__ == "__main__":
    main()
