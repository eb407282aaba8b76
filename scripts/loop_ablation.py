"""Loop-closure ablation on the room-walk session (VERDICT r3 next #2).

r3 finding (docs/SCALE_SLAM.md): loop corrections on the slow-drift
room-walk session were provably non-corrupting but ATE-NEUTRAL — the
uniform-information whole-graph redistribution roughly cancelled the
drift removal at the loop ends.  This harness ablates the r4 candidate
fixes over >= 3 seeds of the same session family:

  off        — loop closing disabled (the drift floor)
  global     — r3 behavior: whole-graph pose correction (oldest-KF gauge)
  localized  — r4 default: the candidate's old-side covisibility group is
               fixed, the correction pulls only the drifted recent chain
  loc+covw   — localized + covisibility-proportional edge information

Runs the device engine (chunked scan + batched loop cadence) so a full
multi-sequence session fits in minutes on the GPU; CPU works with
--kfs 128 --seqs 2.

Usage:
  python scripts/loop_ablation.py --kfs 256 --seqs 2 --seeds 0,1,2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scale_slam_bench import bounded_walk  # noqa: E402


_RENDER_CACHE: dict = {}


def render_session(seed: int, seqs: int, n_pf: int, scene, cam):
    """Pre-render a seed's whole session ONCE (frames are independent of
    the loop-closing config, so the 4-config ablation reuses them)."""
    key = (seed, seqs, n_pf)
    if key in _RENDER_CACHE:
        return _RENDER_CACHE[key]
    from aslam.utils import synthetic_hard as sh

    rng = np.random.default_rng(1000 + seed)
    out = []
    frame_i = 0
    last_C = None
    last_fwd = None
    for s in range(seqs):
        if last_C is None:
            start = rng.uniform([-1.2, -0.1, -1.8], [1.2, 0.1, 1.8])
        else:
            start = np.clip(last_C + rng.normal(0, 0.15, 3),
                            [-1.4, -0.25, -2.0], [1.4, 0.25, 2.0])
        poses = bounded_walk(n_pf, rng, start=start, start_fwd=last_fwd)
        last_C = -poses[-1][:3, :3].T @ poses[-1][:3, 3]
        last_fwd = poses[-1][2, :3].copy()
        imgs, deps = [], []
        for i in range(n_pf):
            gain = 1.0 + 0.15 * np.sin(2 * np.pi * (frame_i + i) / 90.0)
            img, dep, _ = sh.render(cam, poses[i], scene, rng=rng,
                                    illum_gain=gain)
            imgs.append(img)
            deps.append(dep)
        out.append((np.stack(imgs), np.stack(deps), poses))
        frame_i += n_pf
    _RENDER_CACHE[key] = out
    return out


def run_session(cfg, seed: int, seqs: int, n_pf: int, chunk: int,
                scene, cam):
    import jax

    from aslam.models.device_slam import DeviceSlam
    from aslam.utils import trajectory

    rendered = render_session(seed, seqs, n_pf, scene, cam)
    dev = DeviceSlam(cfg, seed=seed, sync_every=4 * chunk,
                     ring=max(8 * chunk, 256))
    gt_all = []
    frame_i = 0
    for s, (imgs, deps, poses) in enumerate(rendered):
        i0 = 0
        if s > 0:
            dev.new_sequence(imgs[0], deps[0], t=frame_i * 0.033)
            gt_all.append(poses[0])
            frame_i += 1
            i0 = 1
        for c0 in range(i0, n_pf, chunk):
            c1 = min(c0 + chunk, n_pf)
            dev.process_chunk(
                imgs[c0:c1], deps[c0:c1],
                ts=[(frame_i + j) * 0.033 for j in range(c1 - c0)])
            gt_all.extend(poses[c0:c1])
            frame_i += c1 - c0
        jax.block_until_ready(dev.state.m.kf_T_cw)
    dev.finish()
    rebuilt = dev.rebuilt_trajectory()
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_all])
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in rebuilt])
    ate = trajectory.ate_rmse(est_c, gt_c)
    n_loops = len(dev.loop_closing.loops) if dev.loop_closing else 0
    n_revisits = (len(dev.loop_closing.consistent_revisits)
                  if dev.loop_closing else 0)
    return ate, n_loops, n_revisits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=256)
    ap.add_argument("--seqs", type=int, default=2)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--frames-per-seq", type=int, default=0)
    ap.add_argument("--configs", default="off,global,localized,loc+covw")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax

    from aslam.config import (BAConfig, CameraModel, ExtractorConfig,
                                  MapConfig, SystemConfig)
    from aslam.utils import synthetic_hard as sh

    cam = CameraModel(fx=258.6, fy=258.2, cx=159.3, cy=127.6,
                      width=320, height=240)
    L = max(args.kfs * 64, 16384)
    base = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(n_features=512, max_keypoints=512),
        map=MapConfig(max_keyframes=args.kfs, max_landmarks=L),
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192),
    )

    def variant(name):
        if name == "off":
            return base.replace(use_loop_closing=False)
        cfg = base.replace(use_loop_closing=True)
        loop = cfg.loop
        if name == "global":
            loop = dataclasses.replace(loop, localized_window=False,
                                       covis_weighted_edges=False)
        elif name == "localized":
            loop = dataclasses.replace(loop, localized_window=True,
                                       covis_weighted_edges=False)
        elif name == "loc+covw":
            loop = dataclasses.replace(loop, localized_window=True,
                                       covis_weighted_edges=True)
        else:
            raise ValueError(name)
        return cfg.replace(loop=loop)

    print("devices:", jax.devices(), flush=True)
    scene_rng = np.random.default_rng(3)
    scene = sh.room_scene(scene_rng, half_x=2.2, half_y=1.4, half_z=2.8)
    n_pf = args.frames_per_seq or int(args.kfs / args.seqs * 2.3)
    seeds = [int(s) for s in args.seeds.split(",")]
    configs = args.configs.split(",")

    results: dict[str, list[float]] = {c: [] for c in configs}
    rows = []
    for cfg_name in configs:
        cfg = variant(cfg_name)
        for seed in seeds:
            t0 = time.time()
            ate, n_loops, n_rev = run_session(
                cfg, seed, args.seqs, n_pf, args.chunk, scene, cam)
            results[cfg_name].append(ate)
            rows.append((cfg_name, seed, ate, n_loops, n_rev))
            print(f"{cfg_name:>10} seed {seed}: ATE {ate:.4f} m  "
                  f"loops={n_loops} revisits={n_rev} "
                  f"[{time.time() - t0:.0f}s]", flush=True)

    print("\n== session ATE (m) over seeds ==", flush=True)
    lines = ["| config | ATE mean ± std | per-seed |", "|---|---|---|"]
    for c in configs:
        v = np.asarray(results[c])
        line = (f"| {c} | {v.mean():.4f} ± {v.std():.4f} | "
                + " ".join(f"{x:.4f}" for x in v) + " |")
        lines.append(line)
        print(f"{c:>10}: {v.mean():.4f} ± {v.std():.4f}   "
              + " ".join(f"{x:.4f}" for x in v), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("# Loop-closure ablation (room-walk sessions)\n\n"
                    f"K={args.kfs}, {args.seqs} sequences, seeds {seeds}, "
                    "device engine.  Generated by "
                    "scripts/loop_ablation.py.\n\n" + "\n".join(lines)
                    + "\n\n| config | seed | ATE | loops | revisits |\n"
                    "|---|---|---|---|---|\n")
            for c, s, a, nl, nr in rows:
                f.write(f"| {c} | {s} | {a:.4f} | {nl} | {nr} |\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
