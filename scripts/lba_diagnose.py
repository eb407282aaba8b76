"""Diagnose local-BA behavior on the hard loop: does the LBA objective's
optimum disagree with ground truth (wrong/biased observations), or does
the optimizer walk away from a good optimum?

Runs SLAM on a hard loop (recording which frame each keyframe came from),
then for the final keyframe's BA window compares:

  chi2(map)   — current map estimates (post-SLAM, LBA applied live)
  chi2(gt)    — window cameras at GROUND-TRUTH poses, window landmarks
                re-backprojected from their first observing window KF's
                measured depth at the gt pose
  cam-err     — translation error of window cams vs gt, before/after one
                more LBA run from each starting point

If chi2(gt) >> chi2(map) while cam-err(map) >> cam-err(gt), the edge set
itself prefers wrong geometry -> association/measurement bias; if
chi2(gt) < chi2(map), the live optimizer failed to find the better basin.

Usage: JAX_PLATFORMS=cpu python scripts/lba_diagnose.py [--frames 120]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from aslam.config import TUM_FR1, SystemConfig  # noqa: E402
from aslam.models import localmapping as lmod  # noqa: E402
from aslam.models.system import SlamSystem  # noqa: E402
from aslam.ops import lba  # noqa: E402
from aslam.utils import camera as cam_mod  # noqa: E402
from aslam.utils import synthetic_hard as sh  # noqa: E402


def chi2_of(prob, cam, cfg):
    *_, chi2, active = lba.edge_terms(prob, cam, cfg, robust=False)
    return float(jnp.sum(jnp.where(active, chi2, 0.0))), int(jnp.sum(active))


def cam_err(cam_T, gt_T, valid):
    errs = []
    for T, G, v in zip(np.asarray(cam_T), gt_T, valid):
        if v and G is not None:
            errs.append(np.linalg.norm((np.linalg.inv(T) @ G)[:3, 3]))
    return float(np.mean(errs)), float(np.max(errs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = SystemConfig(camera=TUM_FR1)
    imgs, depths, gt = sh.make_hard_sequence(
        cfg.camera, kind="loop", n_frames=args.frames, seed=args.seed)
    print("rendered", flush=True)

    slam = SlamSystem(cfg)
    kf_frame = {}  # kf_id -> frame index
    for i in range(args.frames):
        _, info = slam.process(imgs[i], depths[i], t=i * 0.033)
        if info.get("new_kf"):
            kf_frame[slam.tracking.kf_counter - 1] = i
    m = slam.tracking.map
    print(f"{slam.tracking.n_kfs} KFs", flush=True)

    slot = slam.tracking.new_kf_slots[-1]
    spec = lmod.build_window(m, jnp.int32(slot), cfg)
    prob, lw_ids, _ = lmod.build_problem(m, spec, cfg)

    chi2_map, n_act = chi2_of(prob, cfg.camera, cfg.ba)

    # ground-truth window: cams at gt poses, landmarks backprojected from
    # the first observing window cam's stored measurement at the gt pose
    kf_ids = np.asarray(m.kf_id)
    slots = np.asarray(spec.cam_slots)
    valid = np.asarray(spec.cam_valid)
    gt_T = [gt[kf_frame[int(kf_ids[s])]] if v and int(kf_ids[s]) in kf_frame
            else None
            for s, v in zip(slots, valid)]
    cam_T_gt = np.asarray(prob.cam_T).copy()
    for c, G in enumerate(gt_T):
        if G is not None:
            cam_T_gt[c] = G

    C = len(slots)
    M = m.kf_lm.shape[1]
    e_cam = np.asarray(prob.e_cam).reshape(C, M)
    e_lm = np.asarray(prob.e_lm).reshape(C, M)
    e_uv = np.asarray(prob.e_uv).reshape(C, M, 2)
    e_z = np.asarray(prob.e_z).reshape(C, M)
    e_val = np.asarray(prob.e_valid).reshape(C, M)
    Lw = np.asarray(prob.points).shape[0]
    pts_gt = np.asarray(prob.points).copy()
    seen = np.zeros(Lw, bool)
    for c in range(C):
        if gt_T[c] is None:
            continue
        T_wc = np.linalg.inv(cam_T_gt[c])
        for f in range(M):
            l = e_lm[c, f]
            if not e_val[c, f] or seen[l] or e_z[c, f] <= 0:
                continue
            uv = e_uv[c, f]
            z = e_z[c, f]
            p_c = np.asarray(cam_mod.unproject(
                cfg.camera, jnp.asarray(uv[None]), jnp.asarray([z])))[0]
            pts_gt[l] = T_wc[:3, :3] @ p_c + T_wc[:3, 3]
            seen[l] = True

    prob_gt = prob._replace(cam_T=jnp.asarray(cam_T_gt),
                            points=jnp.asarray(pts_gt))
    chi2_gt, n_act_gt = chi2_of(prob_gt, cfg.camera, cfg.ba)

    me_map, xe_map = cam_err(prob.cam_T, gt_T, valid)
    print(f"chi2(map)={chi2_map:.1f} over {n_act} edges | "
          f"chi2(gt)={chi2_gt:.1f} over {n_act_gt} | "
          f"cam-err(map) mean={me_map * 100:.1f}cm max={xe_map * 100:.1f}cm")

    # LBA from the gt start: does optimization IMPROVE or DEGRADE gt?
    out_gt, stats_gt = lba.local_ba(prob_gt, cfg.camera, cfg.ba)
    me_g2, xe_g2 = cam_err(out_gt.cam_T, gt_T, valid)
    print(f"LBA from gt: chi2 -> {float(stats_gt.chi2):.1f}, cam-err "
          f"mean {me_g2 * 100:.1f}cm max {xe_g2 * 100:.1f}cm "
          f"(started at 0 by construction)")

    out_m, stats_m = lba.local_ba(prob, cfg.camera, cfg.ba)
    me_m2, xe_m2 = cam_err(out_m.cam_T, gt_T, valid)
    print(f"LBA from map: chi2 -> {float(stats_m.chi2):.1f}, cam-err "
          f"mean {me_map * 100:.1f} -> {me_m2 * 100:.1f}cm")


if __name__ == "__main__":
    main()
