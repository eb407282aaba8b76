"""Config-5 live-map rehearsal: the SLAM system itself grows a map to
1000+ keyframes across multiple input sequences, with loop closing,
while per-stage wall time is bucketed by live map size.

This is the bench VERDICT r2 demanded: the 10k-KF numbers of
scale_bench.py are standalone synthetic BA problems, while the 256-KF
live ceiling came from O(K*L) derived-structure rebuilds.  After the r3
scale refactor (kf_votes / covis_row / blocked covisibility / compacted
projection matching) the live per-stage cost must grow sub-linearly in
keyframe count; this script measures it end-to-end on a real session:

  * one closed room scene (320x240 raycast renders keep generation
    tractable), several SEQUENCES of a bounded waypoint walk whose step
    size makes nearly every frame a keyframe;
  * `SlamSystem.new_sequence()` between sequences — cross-sequence
    relocalization anchors each new sequence into the SAME map;
  * per-stage timers (tracking step / local mapping / loop closing)
    bucketed by live KF count;
  * final multi-sequence ATE per sequence + overall (rebuilt trajectory).

Usage (GPU by default; JAX_PLATFORMS=cpu works with --kfs 192 --small):
  python scripts/scale_slam_bench.py --kfs 2048 --seqs 4
Writes docs/SCALE_SLAM.md with --out.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bounded_walk(n_frames, rng, half_x=1.6, half_z=2.2, step=0.09,
                 start=None, start_fwd=None):
    """Waypoint random walk inside the room, camera looking along the
    velocity: step size > kf_min_trans makes every frame a keyframe."""
    from aslam.utils.synthetic_hard import _look_at_pose

    C = np.array([0.0, 0.0, 0.0]) if start is None else np.asarray(start)
    wp = rng.uniform([-half_x, -0.25, -half_z], [half_x, 0.25, half_z])
    poses = []
    vel = None if start_fwd is None else np.asarray(start_fwd, np.float64)
    fwd_s = None if start_fwd is None else np.asarray(start_fwd, np.float64)
    for _ in range(n_frames):
        d = wp - C
        if np.linalg.norm(d) < 0.35:
            wp = rng.uniform([-half_x, -0.25, -half_z],
                             [half_x, 0.25, half_z])
            d = wp - C
        d = d / np.linalg.norm(d)
        # inertial motion: velocity turns gradually toward the waypoint,
        # so frame-to-frame rotation stays small enough for matching
        vel = d if vel is None else 0.92 * vel + 0.08 * d
        vel = vel / max(np.linalg.norm(vel), 1e-6)
        C = C + vel * step
        C = np.clip(C, [-half_x, -0.3, -half_z], [half_x, 0.3, half_z])
        fwd = np.array([vel[0], 0.0, vel[2]])
        fwd = fwd / max(np.linalg.norm(fwd), 1e-6)
        fwd_s = fwd if fwd_s is None else 0.9 * fwd_s + 0.1 * fwd
        fwd_s = fwd_s / np.linalg.norm(fwd_s)
        poses.append(_look_at_pose(C.copy(), fwd_s.copy()))
    return np.stack(poses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=1024,
                    help="keyframe capacity / target live size")
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--frames-per-seq", type=int, default=0,
                    help="default: kfs/seqs + margin")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-post-gba", action="store_true",
                    help="loop closing on, but pose-graph-only correction")
    ap.add_argument("--engine", choices=("host", "device"), default="host",
                    help="host = per-stage orchestration (reference "
                    "implementation); device = device-resident pipeline "
                    "(models/device_slam.py, chunked scan + fused mapping)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="device engine: frames per dispatch")
    ap.add_argument("--loop-every", type=int, default=0,
                    help="device engine: frames between loop-closing "
                    "sync reads (default 8*chunk; each sync costs 1-2 "
                    "host reads)")
    ap.add_argument("--fast", action="store_true",
                    help="speed-tuned mapping config: culling cadence 2, "
                    "1 cull round, 3+5 LBA schedule")
    ap.add_argument("--post-gba-method", default="",
                    help="override loop.post_gba_method (e.g. "
                    "sharded_gn_cg = the session invokes the "
                    "covisibility-placed distributed solver)")
    ap.add_argument("--checkpoint-mid", default="",
                    help="device engine: save the session at the midpoint "
                    "sequence to this prefix, then RESUME it into a fresh "
                    "DeviceSlam and continue (mid-session "
                    "checkpoint/resume rehearsal)")
    ap.add_argument("--final-sharded-gba", action="store_true",
                    help="device engine: after the last sequence, the "
                    "session's LoopClosing invokes the covisibility-"
                    "placed distributed GN-CG over the live map (one "
                    "bounded refinement; config-5 contract)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="room scale multiplier (larger room = more "
                    "distinct keyframes before revisits)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import dataclasses

    import jax

    from aslam.config import (BAConfig, CameraModel, ExtractorConfig,
                                  MapConfig, SystemConfig)
    from aslam.models.system import SlamSystem
    from aslam.utils import synthetic_hard as sh
    from aslam.utils import trajectory

    cam = CameraModel(fx=258.6, fy=258.2, cx=159.3, cy=127.6,
                      width=320, height=240)
    L = max(args.kfs * 64, 16384)
    cfg = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(n_features=512, max_keypoints=512),
        map=MapConfig(max_keyframes=args.kfs, max_landmarks=L),
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192),
        use_loop_closing=not args.no_loop,
    )
    if args.no_post_gba:
        import dataclasses as _dc

        cfg = cfg.replace(loop=_dc.replace(cfg.loop, post_gba_iters=0))
    if args.fast:
        import dataclasses as _dc

        cfg = cfg.replace(
            map=_dc.replace(cfg.map, lm_cull_every=2, kf_cull_every=2,
                            kf_cull_rounds=1),
            ba=_dc.replace(cfg.ba, local_iters_1=3, local_iters_2=5),
        )
    if args.post_gba_method:
        import dataclasses as _dc

        cfg = cfg.replace(loop=_dc.replace(
            cfg.loop, post_gba_method=args.post_gba_method))
    print("devices:", jax.devices(), flush=True)
    print(f"capacity: K={args.kfs} L={L}", flush=True)

    rng = np.random.default_rng(3)
    sc = args.scale
    scene = sh.room_scene(rng, half_x=2.2 * sc, half_y=1.4,
                          half_z=2.8 * sc,
                          n_panels=max(4, int(4 * sc)),
                          n_posters=max(10, int(10 * sc * sc)))
    # at 0.09 m/frame the 0.15 m keyframe rule fires every ~2 frames
    n_pf = args.frames_per_seq or int(args.kfs / args.seqs * 2.3)

    if args.engine == "device":
        return run_device(args, cfg, cam, scene, rng, n_pf)

    slam = SlamSystem(cfg, seed=0)
    stage_t: dict[str, list[tuple[int, float]]] = {
        "track": [], "mapping": [], "loop": []}

    # instrument the subsystem calls with per-stage barriers
    import jax as _jax

    orig_lm = slam.local_mapping.process_keyframe
    orig_lc = (slam.loop_closing.process_keyframe
               if slam.loop_closing else None)

    def timed_lm(m, slot, kf_id, n_kfs):
        t0 = time.time()
        m = orig_lm(m, slot, kf_id, n_kfs)
        _jax.block_until_ready(m.kf_T_cw)
        stage_t["mapping"].append((n_kfs, time.time() - t0))
        return m

    slam.local_mapping.process_keyframe = timed_lm
    if orig_lc is not None:
        def timed_lc(m, slot, kf_id):
            t0 = time.time()
            m = orig_lc(m, slot, kf_id)
            _jax.block_until_ready(m.kf_T_cw)
            stage_t["loop"].append((slam.tracking.n_kfs, time.time() - t0))
            return m

        slam.loop_closing.process_keyframe = timed_lc

    gt_all, seq_ranges = [], []
    t_start = time.time()
    frame_i = 0
    last_C = None
    last_fwd = None
    for s in range(args.seqs):
        if last_C is None:
            start = rng.uniform([-1.2, -0.1, -1.8], [1.2, 0.1, 1.8])
        else:
            # realistic session restart: the sensor resumes NEAR where the
            # previous sequence ended, looking roughly the same way (plus
            # a gap the relocalizer / bootstrap search must absorb)
            start = np.clip(last_C + rng.normal(0, 0.15, 3),
                            [-1.4, -0.25, -2.0], [1.4, 0.25, 2.0])
        poses = bounded_walk(n_pf, rng, start=start, start_fwd=last_fwd)
        last_C = -poses[-1][:3, :3].T @ poses[-1][:3, 3]
        last_fwd = poses[-1][2, :3].copy()   # camera +z axis in world
        if s > 0:
            slam.new_sequence()
        lo = frame_i
        for i in range(n_pf):
            gain = 1.0 + 0.15 * np.sin(2 * np.pi * (frame_i) / 90.0)
            img, dep, _ = sh.render(cam, poses[i], scene, rng=rng,
                                    illum_gain=gain)
            t0 = time.time()
            slam.process(img, dep, t=frame_i * 0.033)
            _jax.block_until_ready(slam.tracking.map.kf_T_cw)
            stage_t["track"].append(
                (slam.tracking.n_kfs, time.time() - t0))
            gt_all.append(poses[i])
            frame_i += 1
            if slam.tracking.n_kfs >= cfg.map.max_keyframes - 2:
                break
        seq_ranges.append((lo, frame_i))
        print(f"seq {s}: frames {lo}..{frame_i}  kfs={slam.tracking.n_kfs} "
              f"lms={int(np.asarray(slam.map.lm_valid).sum())} "
              f"loops={len(slam.loop_closing.loops) if slam.loop_closing else 0} "
              f"[{time.time() - t_start:.0f}s]", flush=True)
        if slam.tracking.n_kfs >= cfg.map.max_keyframes - 2:
            break

    # ---- per-stage timing, bucketed by live KF count
    buckets = [0, 128, 256, 512, 1024, 2048, 4096]
    lines = ["| stage | " + " | ".join(
        f"K in [{buckets[i]},{buckets[i + 1]})"
        for i in range(len(buckets) - 1)) + " |",
        "|---|" + "---|" * (len(buckets) - 1)]
    for stage, rec in stage_t.items():
        if not rec:
            continue
        row = [stage]
        for i in range(len(buckets) - 1):
            sel = [dt for k, dt in rec if buckets[i] <= k < buckets[i + 1]]
            # drop the top 2 outliers per bucket (compile / retrain spikes)
            if len(sel) > 4:
                sel = sorted(sel)[:-2]
            row.append(f"{1e3 * np.mean(sel):.0f} ms" if sel else "-")
        lines.append("| " + " | ".join(row) + " |")
    table = "\n".join(lines)
    print(table, flush=True)

    # ---- multi-sequence accuracy
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_all])
    rebuilt = slam.rebuilt_trajectory()
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in rebuilt])
    ate_rows = []
    for s, (lo, hi) in enumerate(seq_ranges):
        ate = trajectory.ate_rmse(est_c[lo:hi], gt_c[lo:hi])
        ate_rows.append((s, hi - lo, ate))
        print(f"seq {s}: ATE {ate:.4f} m over {hi - lo} frames", flush=True)
    ate_all = trajectory.ate_rmse(est_c, gt_c)
    print(f"overall multi-sequence ATE: {ate_all:.4f} m  "
          f"({len(gt_all)} frames, {slam.tracking.n_kfs} KFs)", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(
                "# Live-map scale rehearsal (config 5 precursor)\n\n"
                f"One room scene, {len(seq_ranges)} sequences via "
                "`new_sequence()` + relocalization, every-frame keyframes, "
                f"loop closing {'ON' if not args.no_loop else 'OFF'}; "
                f"capacity K={args.kfs}, L={L}.  Per-stage wall time "
                "bucketed by LIVE keyframe count (generated by "
                "scripts/scale_slam_bench.py; top-2 outliers per bucket "
                "dropped — compile/vocab-train spikes).\n\n"
                + table + "\n\n## Multi-sequence accuracy\n\n"
                "| sequence | frames | ATE (m) |\n|---|---|---|\n")
            for s, n, ate in ate_rows:
                f.write(f"| {s} | {n} | {ate:.4f} |\n")
            f.write(f"| **all** | {len(gt_all)} | **{ate_all:.4f}** |\n")
        print(f"wrote {args.out}")


def run_device(args, cfg, cam, scene, rng, n_pf):
    """Device-resident rehearsal: chunked slam_scan + fused per-KF mapping
    + batched loop cadence (models/device_slam.py).  Frames are
    PRE-RENDERED per sequence so the timed region is the SLAM pipeline
    (tracking scan + mapping dispatches + sync reads), not the synthetic
    raycaster — on a real robot the sensor provides frames for free."""
    import time

    import jax

    from aslam.models.device_slam import DeviceSlam
    from aslam.utils import synthetic_hard as sh
    from aslam.utils import trajectory

    chunk = args.chunk
    loop_every = args.loop_every or 8 * chunk
    dev = DeviceSlam(cfg, seed=0, sync_every=loop_every,
                     ring=max(2 * loop_every, 256))
    gt_all, seq_ranges = [], []
    chunk_rec: list[tuple[int, int, float]] = []   # (k_proxy, frames, dt)
    t_start = time.time()
    frame_i = 0
    last_C = None
    last_fwd = None
    for s in range(args.seqs):
        sc = getattr(args, "scale", 1.0)
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
        t_r0 = time.time()
        imgs, deps = [], []
        for i in range(n_pf):
            gain = 1.0 + 0.15 * np.sin(2 * np.pi * (frame_i + i) / 90.0)
            img, dep, _ = sh.render(cam, poses[i], scene, rng=rng,
                                    illum_gain=gain)
            imgs.append(img)
            deps.append(dep)
        imgs = np.stack(imgs)
        deps = np.stack(deps)
        render_s = time.time() - t_r0

        lo = frame_i
        i0 = 0
        if s > 0:
            ok = dev.new_sequence(imgs[0], deps[0], t=frame_i * 0.033)
            gt_all.append(poses[0])
            frame_i += 1
            i0 = 1
            print(f"seq {s}: re-anchored={ok}", flush=True)
        # one barrier per SEQUENCE, not per chunk: per-chunk barriers
        # would drain the dispatch queue for no information
        t_seq = time.time()
        n_seq_frames = 0
        for c0 in range(i0, n_pf, chunk):
            c1 = min(c0 + chunk, n_pf)
            dev.process_chunk(
                imgs[c0:c1], deps[c0:c1],
                ts=[(frame_i + j) * 0.033 for j in range(c1 - c0)])
            gt_all.extend(poses[c0:c1])
            frame_i += c1 - c0
            n_seq_frames += c1 - c0
            if dev.last_n_kfs >= cfg.map.max_keyframes - 2:
                break
        jax.block_until_ready(dev.state.m.kf_T_cw)
        if dev.loop_closing is None:
            dev.last_n_kfs = int(dev.state.n_kfs)
        chunk_rec.append((dev.last_n_kfs, n_seq_frames,
                          time.time() - t_seq))
        seq_ranges.append((lo, frame_i))
        if getattr(args, "checkpoint_mid", "") and s == args.seqs // 2 - 1:
            from aslam.models.device_slam import DeviceSlam as _DS
            t_ck = time.time()
            dev.save(args.checkpoint_mid)
            dev = _DS.resume(args.checkpoint_mid, cfg, seed=0,
                             sync_every=loop_every,
                             ring=max(2 * loop_every, 256))
            print(f"  [mid-session checkpoint/resume into a fresh "
                  f"DeviceSlam: {time.time() - t_ck:.1f}s]", flush=True)
        print(f"seq {s}: frames {lo}..{frame_i}  kfs~{dev.last_n_kfs} "
              f"mapped={dev.kfs_mapped} "
              f"loops={len(dev.loop_closing.loops) if dev.loop_closing else 0} "
              f"(render {render_s:.0f}s) [{time.time() - t_start:.0f}s]",
              flush=True)
        if dev.last_n_kfs >= cfg.map.max_keyframes - 2:
            break

    if getattr(args, "final_sharded_gba", False) and dev.loop_closing:
        import dataclasses as _dc
        t_g = time.time()
        lc = dev.loop_closing
        old_cfg = lc.cfg
        lc.cfg = old_cfg.replace(loop=_dc.replace(
            old_cfg.loop, post_gba_method="sharded_gn_cg"))
        m2 = lc._post_loop_gba(dev.state.m)
        lc.cfg = old_cfg
        dev.state = dev.state._replace(m=m2)
        print(f"final sharded GN-CG GBA (session-invoked, "
              f"{jax.device_count()} device(s)): {time.time() - t_g:.1f}s",
              flush=True)

    t_fin = time.time()
    traj, stats = dev.finish()
    fin_s = time.time() - t_fin

    # ---- pipeline rate bucketed by live KF count (first chunk = compile)
    buckets = [0, 128, 256, 512, 1024, 2048, 4096]
    lines = ["| metric | " + " | ".join(
        f"K in [{buckets[i]},{buckets[i + 1]})"
        for i in range(len(buckets) - 1)) + " |",
        "|---|" + "---|" * (len(buckets) - 1)]
    row = ["full-pipeline fps"]
    warm = chunk_rec[1:] if len(chunk_rec) > 1 else chunk_rec
    for i in range(len(buckets) - 1):
        sel = [(n, dt) for k, n, dt in warm
               if buckets[i] <= k < buckets[i + 1]]
        if sel:
            fps = sum(n for n, _ in sel) / max(sum(d for _, d in sel), 1e-9)
            row.append(f"{fps:.0f}")
        else:
            row.append("-")
    lines.append("| " + " | ".join(row) + " |")
    # per-sequence rates: with a cold compile cache the early sequences
    # carry one-time XLA compiles; the
    # per-sequence view separates those from the steady state
    seq_lines = ["", "Per-sequence pipeline rate (seq 0 carries the "
                 "bootstrap + first-chunk compiles when the compile "
                 "cache is cold):", ""]
    for si, (k, n, dt) in enumerate(chunk_rec):
        seq_lines.append(f"- seq {si}: {n} frames / {dt:.1f} s = "
                         f"**{n / max(dt, 1e-9):.0f} fps** (K~{k})")
    table = "\n".join(lines) + "\n" + "\n".join(seq_lines)
    print(table, flush=True)
    n_warm = sum(n for _, n, _ in warm)
    t_warm = sum(d for _, _, d in warm)
    fps_all = n_warm / max(t_warm, 1e-9)
    print(f"sustained full-pipeline rate: {fps_all:.1f} fps "
          f"({n_warm} frames, {t_warm:.1f}s; compile chunk excluded; "
          f"finish/flush {fin_s:.1f}s)", flush=True)

    # ---- multi-sequence accuracy (rebuilt trajectory, like the host path)
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_all])
    rebuilt = dev.rebuilt_trajectory()
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in rebuilt])
    ate_rows = []
    for s, (lo, hi) in enumerate(seq_ranges):
        ate = trajectory.ate_rmse(est_c[lo:hi], gt_c[lo:hi])
        ate_rows.append((s, hi - lo, ate))
        print(f"seq {s}: ATE {ate:.4f} m over {hi - lo} frames", flush=True)
    ate_all = trajectory.ate_rmse(est_c, gt_c)
    print(f"overall multi-sequence ATE: {ate_all:.4f} m  "
          f"({len(gt_all)} frames, ~{dev.last_n_kfs} KFs, device engine)",
          flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(
                "# Device-engine scale rehearsal\n\n"
                f"{len(seq_ranges)} sequences, chunk={args.chunk}, "
                f"loop closing {'ON' if not args.no_loop else 'OFF'}, "
                f"capacity K={args.kfs}.  Chunked device pipeline "
                "(tracking scan + fused per-KF mapping + batched loop "
                "cadence), frames pre-rendered.\n\n"
                + table
                + f"\n\nSustained: **{fps_all:.1f} fps**\n\n"
                "## Multi-sequence accuracy\n\n"
                "| sequence | frames | ATE (m) |\n|---|---|---|\n")
            for s, n, ate in ate_rows:
                f.write(f"| {s} | {n} | {ate:.4f} |\n")
            f.write(f"| **all** | {len(gt_all)} | **{ate_all:.4f}** |\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
