"""Multi-seed / multi-scene SLAM accuracy matrix.

Single-seed ATE of a drifting SLAM run is dominated by run-to-run chaos
(a shifted keyframe cadence reshuffles every downstream decision), so any
config comparison needs several seeds x scenes.  This harness runs a
named-config x scene x seed matrix in parallel worker subprocesses and
prints mean +/- stdev frozen/rebuilt ATE per (config, scene).

Usage:
  JAX_PLATFORMS=cpu python scripts/slam_matrix.py \
      --frames 150 --seeds 0,1,2 --kinds loop,sweep \
      --configs base,patch,nolba --jobs 2

Named configs live in CONFIGS below; each is a function SystemConfig ->
(SystemConfig, use_loop_closing).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ba(cfg, **kw):
    return cfg.replace(ba=dataclasses.replace(cfg.ba, **kw))


def _map(cfg, **kw):
    return cfg.replace(map=dataclasses.replace(cfg.map, **kw))


def _ext(cfg, **kw):
    return cfg.replace(extractor=dataclasses.replace(cfg.extractor, **kw))


def _trk(cfg, **kw):
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **kw))


# name -> (transform(cfg) -> cfg, use_loop_closing)
CONFIGS = {
    # reference-semantics everything
    "ref": (lambda c: _ext(_map(_ba(c, info_model="inv_z2"),
                                refresh_positions=False), depth_patch=1),
            False),
    "base": (lambda c: _ext(_map(c, refresh_positions=False), depth_patch=1),
             False),
    "patch": (lambda c: _ext(_map(c, refresh_positions=False), depth_patch=3),
              False),
    "refresh": (lambda c: _ext(_map(c, refresh_positions=True), depth_patch=1),
                False),
    "both": (lambda c: _ext(_map(c, refresh_positions=True), depth_patch=3),
             False),
    "nolba": (lambda c: _ext(_map(c, refresh_positions=False,
                                  enable_local_ba=False), depth_patch=3),
              False),
    "nolba-refresh": (lambda c: _ext(_map(c, refresh_positions=True,
                                          enable_local_ba=False),
                                     depth_patch=3),
                      False),
    "default": (lambda c: c, False),
    "default-loop": (lambda c: c, True),
    "vo": (lambda c: c, False),   # handled specially: pure odometry chain
    # odometry-prior fusion sweep (r3): default stack with the pose prior
    # at different stiffnesses; "noprior" = the r2 unconstrained re-solve
    "noprior": (lambda c: _trk(c, pose_prior_weight=0.0), False),
    "prior2e5": (lambda c: _trk(c, pose_prior_weight=2.0e5), False),
    "prior2e7": (lambda c: _trk(c, pose_prior_weight=2.0e7), False),
    "noprior-loop": (lambda c: _trk(c, pose_prior_weight=0.0), True),
}


def run_one(config: str, kind: str, seed: int, frames: int) -> dict:
    import jax.numpy as jnp  # noqa: F401

    from aslam.config import TUM_FR1, SystemConfig
    from aslam.utils import synthetic_hard as sh
    from aslam.utils import trajectory

    cfg = SystemConfig(camera=TUM_FR1)
    fn, use_loop = CONFIGS[config]
    cfg = fn(cfg)
    imgs, depths, gt = sh.make_hard_sequence(
        cfg.camera, kind=kind, n_frames=frames, seed=seed)
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt])

    if config == "vo":
        import jax

        from aslam.models import frame as frame_mod
        from aslam.models.extractor import init_adaptive_state
        from aslam.models.odometry import rba_step

        st = init_adaptive_state(cfg.extractor)
        fr = []
        for i in range(frames):
            f, st = frame_mod.make_frame(
                jnp.asarray(imgs[i]), jnp.asarray(depths[i]), cfg, st)
            fr.append(f)
        key = jax.random.PRNGKey(seed)
        poses = [np.eye(4)]
        f_prev = frame_mod.with_pose(fr[0], jnp.eye(4))
        for i in range(1, frames):
            key, sub = jax.random.split(key)
            res = rba_step(f_prev, fr[i], sub, cfg)
            f_prev = frame_mod.with_pose(fr[i], res.T_cw2)
            poses.append(np.asarray(res.T_cw2))
        est = np.stack(poses)
        c = np.stack([np.linalg.inv(T)[:3, 3] for T in est])
        ate = trajectory.ate_rmse(c, gt_c)
        return {"config": config, "kind": kind, "seed": seed,
                "ate_frozen": float(ate), "ate_rebuilt": float(ate),
                "kfs": 0}

    from aslam.models.system import SlamSystem

    slam = SlamSystem(cfg.replace(use_loop_closing=use_loop))
    for i in range(frames):
        slam.process(imgs[i], depths[i], t=i * 0.033)
    frozen = np.stack(slam.tracking.poses)
    rebuilt = slam.rebuilt_trajectory()
    c_f = np.stack([np.linalg.inv(T)[:3, 3] for T in frozen])
    c_r = np.stack([np.linalg.inv(T)[:3, 3] for T in rebuilt])
    return {
        "config": config, "kind": kind, "seed": seed,
        "ate_frozen": float(trajectory.ate_rmse(c_f, gt_c)),
        "ate_rebuilt": float(trajectory.ate_rmse(c_r, gt_c)),
        "kfs": int(slam.tracking.n_kfs),
        "loops": len(slam.loop_closing.loops) if slam.loop_closing else 0,
    }


def _card_count() -> int:
    """GPUs on this host, 0 for a CPU run.  Read with nvidia-smi so the
    parent never starts a JAX client (which would hold a card's memory)."""
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return len(out.split())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--kinds", default="loop,sweep")
    ap.add_argument("--configs", default="base,patch,nolba")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--worker", nargs=4, metavar=("CFG", "KIND", "SEED", "N"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        cfg, kind, seed, n = args.worker
        out = run_one(cfg, kind, int(seed), int(n))
        print("RESULT " + json.dumps(out), flush=True)
        return

    seeds = [int(s) for s in args.seeds.split(",")]
    kinds = args.kinds.split(",")
    configs = args.configs.split(",")
    jobs = [(c, k, s) for c in configs for k in kinds for s in seeds]
    results = []
    running: list[tuple[tuple, subprocess.Popen, int]] = []
    # one worker per card: a JAX process reserves most of a card's memory
    n_cards = _card_count()
    if n_cards:
        args.jobs = min(args.jobs, n_cards)
    free_cards = list(range(n_cards))

    def drain(block: bool):
        for spec, p, card in list(running):
            if p.poll() is None and not block:
                continue
            out, _ = p.communicate()
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[7:])
                    results.append(r)
                    print(f"  {r['config']:>14s} {r['kind']:>6s} "
                          f"s{r['seed']} -> frozen {r['ate_frozen']:.4f} "
                          f"rebuilt {r['ate_rebuilt']:.4f} "
                          f"kfs {r['kfs']}", flush=True)
                    break
            else:
                print(f"  WORKER FAILED {spec}:\n{out[-2000:]}", flush=True)
            running.remove((spec, p, card))
            if card >= 0:
                free_cards.append(card)

    import time

    for spec in jobs:
        while len(running) >= args.jobs:
            drain(block=False)
            if len(running) >= args.jobs:
                # poll-sleep rather than wait(): wait() on a stdout=PIPE
                # child can deadlock if the child fills the ~64KB pipe
                # buffer before exiting
                time.sleep(0.5)
        c, k, s = spec
        env = dict(os.environ)
        card = free_cards.pop(0) if n_cards else -1
        if card >= 0:
            env["CUDA_VISIBLE_DEVICES"] = str(card)
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             c, k, str(s), str(args.frames)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        running.append((spec, p, card))
    while running:
        drain(block=True)

    print("\n== mean ATE (frozen / rebuilt) over seeds ==")
    for c in configs:
        row = [f"{c:>14s}"]
        for k in kinds:
            f = [r["ate_frozen"] for r in results
                 if r["config"] == c and r["kind"] == k]
            rb = [r["ate_rebuilt"] for r in results
                  if r["config"] == c and r["kind"] == k]
            if f:
                row.append(f"{k}: {np.mean(f):.4f}±{np.std(f):.4f} / "
                           f"{np.mean(rb):.4f}±{np.std(rb):.4f}")
            else:
                row.append(f"{k}: n/a")
        print("  " + "  |  ".join(row))


if __name__ == "__main__":
    main()
