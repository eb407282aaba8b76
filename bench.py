"""Benchmark: frames/s of the two cells on one GPU, in one process.

  VO:        frame-to-frame tracking (extraction, knn match, 256-hypothesis
             RANSAC, motion-only BA) at 640x480 / 1024 keypoints, as a
             per-frame stream and as 64-frame `track_sequence` chunks.
  Full SLAM: `DeviceSlam` at `workloads.full_config()` (K=256, loop
             closing on) over the 257-frame walk in 64-frame chunks.

Each timed window ends at `jax.block_until_ready`.  Both cells check their
trajectory against ground truth (ATE <= 10 cm); a failed check, or a run
without a GPU, exits non-zero.  The last line of standard output is one
JSON object: the SLAM rate leads, the VO rates ride along.

vs_baseline divides by 30 frames/s, the ORB-SLAM2-class tracking rate on a
desktop CPU that this ORB-SLAM2-derived system targets (the reference
publishes no numbers, BASELINE.md).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

REFERENCE_FPS = 30.0
ATE_GATE_M = 0.10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_vo(cfg, chunk: int = 64, n_passes: int = 6) -> dict:
    import jax
    import jax.numpy as jnp

    from aslam import workloads
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.models.odometry import track_frame, track_sequence
    from aslam.utils.trajectory import ate_rmse

    cam = cfg.camera
    H, W = cam.height, cam.width
    # distinct frames for every pass
    imgs, deps, poses = workloads.vo_sequence(cam, chunk * n_passes)
    keys = jax.random.split(jax.random.PRNGKey(0), chunk * n_passes)

    t0 = time.perf_counter()
    f0, st = frame_mod.make_frame(jnp.asarray(imgs[0]), jnp.asarray(deps[0]),
                                  cfg, init_adaptive_state(cfg.extractor))
    f0 = frame_mod.with_pose(f0, jnp.eye(4))
    grid = st.grid_thresholds
    out = track_frame(f0, jnp.asarray(imgs[1]), jnp.asarray(deps[1]), grid,
                      keys[0], cfg, H, W)
    jax.block_until_ready(out)
    log(f"vo: stream compile+warmup {time.perf_counter() - t0:.1f} s")

    # stream: one dispatch per frame (the sensor-driven shape)
    prev, poses_est = f0, []
    t0 = time.perf_counter()
    for i in range(1, chunk):
        prev, grid, res = track_frame(
            prev, jnp.asarray(imgs[i]), jnp.asarray(deps[i]), grid, keys[i],
            cfg, H, W)
        poses_est.append(res.T_cw2)
    jax.block_until_ready(poses_est)
    stream_fps = (chunk - 1) / (time.perf_counter() - t0)
    est = np.concatenate([np.eye(4)[None], np.stack(poses_est)])
    ate = ate_rmse(workloads.centers(est), workloads.centers(poses[:chunk]))
    log(f"vo: stream {stream_fps:.1f} frames/s, ATE {ate * 100:.3f} cm")

    # chunked: one lax.scan dispatch per pass, next pass's upload overlapped
    def put(rep):
        lo = rep * chunk
        return (jax.device_put(imgs[lo + 1: lo + chunk]),
                jax.device_put(deps[lo + 1: lo + chunk]))

    t0 = time.perf_counter()
    out = track_sequence(f0, *put(0), grid, keys[1:chunk], cfg, H, W)
    jax.block_until_ready(out)
    log(f"vo: chunked compile+warmup {time.perf_counter() - t0:.1f} s")
    bufs, prev, results = put(1), f0, []
    t0 = time.perf_counter()
    for rep in range(1, n_passes):
        lo = rep * chunk
        prev, grid, seq = track_sequence(
            prev, *bufs, grid, keys[lo + 1: lo + chunk], cfg, H, W)
        if rep + 1 < n_passes:
            bufs = put(rep + 1)
        results.append(seq.T_cw)
    jax.block_until_ready(results)
    n_timed = (n_passes - 1) * (chunk - 1)
    chunk_fps = n_timed / (time.perf_counter() - t0)
    log(f"vo: chunked {n_timed} frames -> {chunk_fps:.1f} frames/s")
    if not ate <= ATE_GATE_M:
        raise SystemExit(f"bench: VO ATE {ate:.4f} m over the gate")
    return dict(stream_fps=stream_fps, fps=max(stream_fps, chunk_fps),
                ate_cm=ate * 100)


def run_slam(cfg, n_frames: int = 257, chunk: int = 64) -> dict:
    from aslam import workloads
    from aslam.utils.trajectory import ate_rmse

    imgs, deps, poses = workloads.slam_walk(cfg.camera, n_frames)
    t0 = time.perf_counter()
    workloads.slam_pass(cfg, imgs, deps, chunk, seed=0)
    log(f"slam: compile pass {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dev = workloads.slam_pass(cfg, imgs, deps, chunk, seed=1)
    dt = time.perf_counter() - t0
    fps = n_frames / dt
    dev.finish()
    ate = ate_rmse(workloads.centers(dev.rebuilt_trajectory()),
                   workloads.centers(poses))
    n_kfs = int(dev.state.n_kfs)
    log(f"slam: {n_frames} frames in {dt:.2f} s -> {fps:.1f} frames/s "
        f"({n_kfs} KFs), rebuilt-trajectory ATE {ate * 100:.3f} cm")
    if not ate <= ATE_GATE_M:
        raise SystemExit(f"bench: SLAM ATE {ate:.4f} m over the gate")
    return dict(fps=fps, ate_cm=ate * 100, n_kfs=n_kfs)


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: JAX backend is {jax.default_backend()!r}, "
                         "not 'gpu'; nothing was measured")
    from aslam import workloads

    d = jax.devices()[0]
    log("devices:", jax.devices())
    cfg = workloads.full_config()
    vo = run_vo(cfg)
    slam = run_slam(cfg)
    print(json.dumps({
        "metric": "slam_fps_per_chip",
        "value": round(slam["fps"], 2),
        "unit": "frames/s",
        "vs_baseline": round(slam["fps"] / REFERENCE_FPS, 3),
        "ate_cm": round(slam["ate_cm"], 3),
        "n_kfs": slam["n_kfs"],
        "vo_fps": round(vo["fps"], 2),
        "vo_stream_fps": round(vo["stream_fps"], 2),
        "vo_ate_cm": round(vo["ate_cm"], 3),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
