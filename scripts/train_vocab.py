"""Train the shipped BoW vocabulary artifact on a DIVERSE synthetic corpus.

The reference loads a pretrained ~100 MB DBoW3 vocabulary trained offline
on generic imagery (main.cpp:67 — the artifact is absent from its repo).
Our equivalent: hierarchical binary k-medians over ORB descriptors from
many DIFFERENT hard-synthetic scenes (distinct texture/poster/panel seeds,
loop + sweep trajectories), so the tree learns the descriptor distribution
of the front-end rather than one room's appearance.  Training seeds are
disjoint from the evaluation seeds used by vocab_study/accuracy_compare
(0..9) to keep the recall numbers honest generalization measurements.

Usage:
  JAX_PLATFORMS=cpu python scripts/train_vocab.py \
      [--branching 10 --depth 4 --scenes 6 --frames 30 --cap 200000]

Writes aslam/assets/vocab_{B}_{D}.npz (a few hundred KB at 10^4 words)
— loaded by default by LoopClosing (config.loop.use_pretrained_vocab).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from aslam.config import TUM_FR1, SystemConfig  # noqa: E402
from aslam.models import frame as frame_mod  # noqa: E402
from aslam.models.extractor import init_adaptive_state  # noqa: E402
from aslam.ops import bow  # noqa: E402
from aslam.utils import synthetic_hard as sh  # noqa: E402


def _photometric_variants(img: np.ndarray, rng: np.random.Generator,
                          n: int) -> list[np.ndarray]:
    """Gain/gamma/bias/noise variants of a frame — the vocabulary should
    place a descriptor in the same leaf across illumination changes."""
    out = []
    for _ in range(n):
        gain = rng.uniform(0.5, 1.6)
        gamma = rng.uniform(0.7, 1.4)
        bias = rng.uniform(-25, 25)
        x = np.clip(img, 0, 255) / 255.0
        x = np.power(x, gamma) * gain * 255.0 + bias
        x = x + rng.normal(0, rng.uniform(0.5, 4.0), img.shape)
        out.append(np.clip(x, 0, 255).astype(np.float32))
    return out


def _warp_variant(img: np.ndarray, depth: np.ndarray,
                  rng: np.random.Generator):
    """Random affine warp (rotation/scale/shear, bilinear resample) of an
    image+depth pair — viewpoint-change augmentation for the corpus."""
    h, w = img.shape
    ang = rng.uniform(-0.35, 0.35)
    s = rng.uniform(0.8, 1.25)
    shear = rng.uniform(-0.15, 0.15)
    ca, sa = np.cos(ang) * s, np.sin(ang) * s
    A = np.array([[ca, -sa + shear], [sa, ca]])
    cx, cy = w / 2, h / 2
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    # inverse map: output pixel -> source coords
    Ainv = np.linalg.inv(A)
    sx = Ainv[0, 0] * (xx - cx) + Ainv[0, 1] * (yy - cy) + cx
    sy = Ainv[1, 0] * (xx - cx) + Ainv[1, 1] * (yy - cy) + cy
    x0 = np.clip(np.floor(sx).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(np.int32), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)

    def bilerp(a):
        return ((1 - fy) * ((1 - fx) * a[y0, x0] + fx * a[y0, x0 + 1])
                + fy * ((1 - fx) * a[y0 + 1, x0] + fx * a[y0 + 1, x0 + 1]))

    return (bilerp(img).astype(np.float32),
            bilerp(depth).astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--cap", type=int, default=500_000)
    ap.add_argument("--photo-aug", type=int, default=1,
                    help="photometric variants per frame (0 disables)")
    ap.add_argument("--warp-aug", type=int, default=1,
                    help="warped variants per frame (0 disables)")
    ap.add_argument("--seed0", type=int, default=100,
                    help="first scene seed (eval seeds 0..9 stay disjoint)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from aslam.utils import synthetic as syn

    cfg = SystemConfig(camera=TUM_FR1)
    pool = []
    t0 = time.time()
    aug_rng = np.random.default_rng(7)

    def extract_all(frames_nd, depths_nd):
        st = init_adaptive_state(cfg.extractor)
        for img, dep in zip(frames_nd, depths_nd):
            f, st = frame_mod.make_frame(
                jnp.asarray(img), jnp.asarray(dep), cfg, st)
            pool.append(np.asarray(f.feat.desc)[np.asarray(f.feat.valid)])

    for s in range(args.scenes):
        seed = args.seed0 + s
        fam = s % 4
        if fam < 3:
            # procedural room family: loop/sweep walks over distinct
            # texture/poster/panel seeds
            kind = "loop" if fam % 2 == 0 else "sweep"
            imgs, depths, _ = sh.make_hard_sequence(
                cfg.camera, kind=kind, n_frames=args.frames, seed=seed)
        else:
            # point-splat family (utils/synthetic.py): different image
            # statistics from the textured-surface renderer
            rng_s = np.random.default_rng(seed)
            pts = syn.random_scene(rng_s, 1200)
            tex = syn.point_textures(1200, seed=seed)
            poses = syn.camera_trajectory(
                args.frames, step_t=0.05, step_r=0.02, rng=rng_s)
            imgs = np.stack([
                syn.render_intensity_image(cfg.camera, T, pts, tex)
                for T in poses])
            depths = np.stack([
                syn.render_depth_image(cfg.camera, T, pts, splat=4)
                for T in poses])
        frames_nd = list(imgs)
        depths_nd = list(depths)
        for i in range(len(imgs)):
            for v in _photometric_variants(imgs[i], aug_rng, args.photo_aug):
                frames_nd.append(v)
                depths_nd.append(depths[i])
            for _ in range(args.warp_aug):
                wi, wd = _warp_variant(imgs[i], depths[i], aug_rng)
                frames_nd.append(wi)
                depths_nd.append(wd)
        extract_all(frames_nd, depths_nd)
        print(f"scene {s} (family {fam}, seed {seed}): "
              f"{sum(len(p) for p in pool)} descriptors so far "
              f"[{time.time() - t0:.0f}s]", flush=True)

    descs = np.concatenate(pool)
    rng = np.random.default_rng(0)
    if len(descs) > args.cap:
        descs = descs[rng.choice(len(descs), args.cap, replace=False)]
    print(f"training {args.branching}^{args.depth} vocabulary on "
          f"{len(descs)} descriptors...", flush=True)
    t0 = time.time()
    vocab = bow.train_vocabulary(
        descs, branching=args.branching, depth=args.depth)
    print(f"trained in {time.time() - t0:.0f}s", flush=True)

    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "aslam", "assets",
        f"vocab_{args.branching}_{args.depth}.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    bow.save_vocabulary(out, vocab)
    print(f"wrote {out} ({os.path.getsize(out) / 1024:.0f} KB)")


if __name__ == "__main__":
    main()
