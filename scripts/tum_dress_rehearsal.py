"""Real-dataset dress rehearsal (VERDICT r3 missing #1 / next #8).

This environment has zero egress and no TUM data on disk, so the one
thing that cannot be measured here is accuracy on real sensor imagery.
What CAN be proven — and is, by this script — is that the day real data
arrives it is a *path* change, not a *code* change: the full ingest and
evaluation pipeline runs end-to-end exactly as it would on
`rgbd_dataset_freiburg1_xyz`:

  1. generate an ON-DISK 640x480 TUM-format sequence: 8-bit RGB PNGs
     (3-channel, to exercise the gray conversion), 16-bit depth PNGs at
     1/5000 m counts, `associations.txt`, `groundtruth.txt` — the exact
     layout `Utils/utils.cpp:16-38` loads;
  2. run the REAL CLI (`python -m aslam.main --dataset <dir>
     --camera fr1 --mode slam+loop`) as a subprocess — TumSequence +
     native PNG decode/prefetch (aslam/native), full SLAM with loop
     closing, trajectory + histogram exports (main.cpp:124-126);
  3. evaluate `CameraTrajectory.txt` against `groundtruth.txt` with the
     TUM ATE metric (Umeyama-aligned RMSE) and write
     `results/TUM_REHEARSAL.md`.

Usage:
  JAX_PLATFORMS=cpu python scripts/tum_dress_rehearsal.py \
      --frames 120 --workdir tum_rehearsal
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def generate_sequence(out_dir: str, n_frames: int, seed: int = 0):
    """Write a TUM-layout sequence + ground truth to `out_dir`."""
    from aslam.config import TUM_FR1
    from aslam.utils import synthetic_hard as sh
    from aslam.utils.dataset import write_tum_sequence
    from aslam.workloads import to_sensor

    cam = TUM_FR1  # 640x480, fr1 intrinsics WITH lens distortion
    imgs, depths, poses = sh.make_hard_sequence(
        cam, kind="loop", n_frames=n_frames, seed=seed)
    write_tum_sequence(out_dir, *to_sensor(imgs, depths, cam), poses)
    return poses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--workdir", default="tum_rehearsal")
    ap.add_argument("--mode", default="slam+loop")
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "TUM_REHEARSAL.md"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=["host", "device"], default="host",
                    help="CLI engine to drive (the device engine is the "
                    "production path: chunked slam_scan on the "
                    "accelerator)")
    ap.add_argument("--chunk", type=int, default=64)
    args = ap.parse_args(argv)

    seq_dir = os.path.join(args.workdir, "rgbd_dataset_synthetic_fr1")
    out_dir = os.path.join(args.workdir, "out")
    print(f"generating {args.frames}-frame 640x480 TUM sequence "
          f"-> {seq_dir}", flush=True)
    t0 = time.time()
    generate_sequence(seq_dir, args.frames, seed=args.seed)
    print(f"  rendered+encoded in {time.time() - t0:.0f}s", flush=True)

    # the real CLI, as a user would run it
    cmd = [sys.executable, "-m", "aslam.main",
           "--dataset", seq_dir, "--camera", "fr1", "--mode", args.mode,
           "--out-dir", out_dir, "--engine", args.engine,
           "--chunk", str(args.chunk)]
    print("running:", " ".join(cmd), flush=True)
    t0 = time.time()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    wall = time.time() - t0
    sys.stdout.write(r.stdout[-2000:])
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        raise SystemExit(f"CLI failed rc={r.returncode}")

    # TUM-style evaluation: CameraTrajectory.txt vs groundtruth.txt
    from aslam.utils import trajectory

    est = np.loadtxt(os.path.join(out_dir, "CameraTrajectory.txt"))
    gt = np.loadtxt(os.path.join(seq_dir, "groundtruth.txt"))
    assert est.shape[0] == gt.shape[0] == args.frames
    # rows are camera-in-world positions in both files
    ate = trajectory.ate_rmse(est[:, 1:4], gt[:, 1:4])
    for fname in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt",
                  "Histogram.csv", "metrics.json"):
        assert os.path.exists(os.path.join(out_dir, fname)), fname
    kf = np.loadtxt(os.path.join(out_dir, "KeyFrameTrajectory.txt"))
    print(f"ATE RMSE (Umeyama-aligned, TUM metric): {ate * 100:.2f} cm "
          f"over {args.frames} frames, {len(kf)} keyframes, "
          f"{wall / args.frames * 1e3:.0f} ms/frame wall", flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(
            "# TUM-format dress rehearsal\n\n"
            "Generated by `scripts/tum_dress_rehearsal.py`: an on-disk "
            "640x480 TUM-layout sequence (8-bit RGB PNG, 16-bit depth "
            "PNG at 1/5000 counts, associations.txt, groundtruth.txt; "
            "fr1 intrinsics WITH lens distortion, hard-suite loop "
            "trajectory) ingested by the real CLI through the native "
            "PNG decoder/prefetcher:\n\n"
            "```\npython -m aslam.main --dataset "
            "rgbd_dataset_synthetic_fr1 --camera fr1 --mode "
            f"{args.mode} --out-dir out\n```\n\n"
            f"| metric | value |\n|---|---|\n"
            f"| frames | {args.frames} |\n"
            f"| keyframes | {len(kf)} |\n"
            f"| engine | {args.engine} |\n"
            f"| ATE RMSE (TUM metric) | **{ate * 100:.2f} cm** |\n"
            f"| wall clock | {wall:.0f} s ({wall / args.frames * 1e3:.0f} "
            "ms/frame incl. compile) |\n\n"
            "Exports verified present: CameraTrajectory.txt, "
            "KeyFrameTrajectory.txt, Histogram.csv, metrics.json "
            "(main.cpp:124-126 parity).  When real TUM data is "
            "available, only `--dataset` changes.\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
