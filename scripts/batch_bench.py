"""Aggregate throughput of batched VO (B sequences per chip)."""
import argparse, time
import numpy as np

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()
    import jax
    from aslam.config import SystemConfig, CameraModel
    from aslam.models.batch_vo import BatchVisualOdometry
    from aslam.utils import synthetic
    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
    cfg = SystemConfig(camera=cam)
    print("devices:", jax.devices(), flush=True)
    print("rendering...", flush=True)
    seqs = [synthetic.make_sequence(n_frames=args.frames, n_points=1500,
                                    cam=cam, seed=50 + b)
            for b in range(args.batch)]
    stack_i = [np.stack([np.clip(seqs[b][0][f],0,255).astype(np.uint8)
                         for b in range(args.batch)]) for f in range(args.frames)]
    stack_d = [np.stack([np.clip(seqs[b][1][f]/cam.depth_factor,0,65535).astype(np.uint16)
                         for b in range(args.batch)]) for f in range(args.frames)]
    bvo = BatchVisualOdometry(cfg, batch=args.batch)
    t0=time.time()
    bvo.process(stack_i[0], stack_d[0])
    bvo.process(stack_i[1], stack_d[1])
    jax.block_until_ready(bvo.prev.T_cw)
    print(f"compile {time.time()-t0:.1f}s", flush=True)
    t0=time.time()
    for f in range(2, args.frames):
        bvo.process(stack_i[f], stack_d[f])
        jax.block_until_ready(bvo.prev.T_cw)
    dt=time.time()-t0
    n=(args.frames-2)*args.batch
    print(f"batch={args.batch}: {n} frame-tracks in {dt:.3f}s -> "
          f"{n/dt:.0f} aggregate fps/chip", flush=True)

if __name__ == "__main__":
    main()
