"""Detector/descriptor speed + keypoint statistics.

Equivalent of the reference's standalone test programs
`Tests/detector-speed-test.cpp` (per-detector mean detect time + KP count
stats) and `Tests/detector-descriptor-speed-test.cpp` (detect+describe
timing) — run over synthetic frames (or a TUM sequence via --dataset).

Usage: python scripts/detector_bench.py [--dataset DIR] [--frames N]
           [--detectors FAST,GFTT,...] [--descriptors ORB,BRIEF,...]

With --detectors/--descriptors the bench sweeps the family grid (the
reference's det x desc loops, detector-descriptor-speed-test.cpp:30-60);
without them it times the main FAST/ORB pipeline configs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--csv", default="")
    ap.add_argument("--detectors", default="",
                    help="comma list (FAST,GFTT,HARRIS,DOG,HESSIAN,STAR)")
    ap.add_argument("--descriptors", default="",
                    help="comma list (ORB,BRIEF,FREAK,LATCH,SIFT)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from aslam.config import ExtractorConfig, SystemConfig
    from aslam.models.extractor import extract_features, init_adaptive_state
    from aslam.utils import synthetic

    if args.dataset:
        from aslam.utils.dataset import TumSequence

        seq = TumSequence(args.dataset)
        frames = [seq[i][1] for i in range(min(args.frames, len(seq)))]
    else:
        cfg0 = SystemConfig()
        imgs, _, _, _ = synthetic.make_sequence(
            n_frames=args.frames, n_points=1200, cam=cfg0.camera, seed=1
        )
        frames = list(imgs)

    rows = []

    def bench(name: str, cfg: ExtractorConfig):
        state = init_adaptive_state(cfg)
        # warm
        f, state = extract_features(jnp.asarray(frames[0]), cfg, state)
        jax.block_until_ready(f.xy)
        counts, times = [], []
        for img in frames[1:]:
            t0 = time.perf_counter()
            f, state = extract_features(jnp.asarray(img), cfg, state)
            jax.block_until_ready(f.xy)
            times.append(time.perf_counter() - t0)
            counts.append(int(jnp.sum(f.valid)))
        rows.append((name, np.mean(times) * 1e3, np.std(times) * 1e3,
                     np.mean(counts), np.std(counts)))
        print(f"{name:16s} {np.mean(times)*1e3:7.2f} ms/frame "
              f"(+-{np.std(times)*1e3:5.2f})  "
              f"kps {np.mean(counts):7.1f} (+-{np.std(counts):5.1f})")

    if args.detectors or args.descriptors:
        # family grid sweep (detector-descriptor-speed-test.cpp semantics)
        dets = (args.detectors or "FAST").split(",")
        descs = (args.descriptors or "ORB").split(",")
        for det in dets:
            for desc in descs:
                cfg = ExtractorConfig(detector=det.strip(),
                                      descriptor=desc.strip())
                bench(f"{det.strip()}-{desc.strip()}", cfg)
    else:
        for adaptive in (False, True):
            for n_levels in (1, 8):
                cfg = ExtractorConfig(adaptive=adaptive, n_levels=n_levels)
                bench(f"{'adaptive' if adaptive else 'static'}-L{n_levels}",
                      cfg)

    if args.csv:
        with open(args.csv, "w") as f:
            f.write("config,mean_ms,std_ms,mean_kps,std_kps\n")
            for r in rows:
                f.write(",".join(str(x) for x in r) + "\n")


if __name__ == "__main__":
    main()
