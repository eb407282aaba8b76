"""Why doesn't the pretrained vocabulary transfer? (VERDICT r3 next #6)

r3 measured a cross-scene vocabulary at AP 0.060 vs 0.393 in-run; r4
retrained on a 3.4x larger, 4-family, photometric+warp-augmented corpus
(scripts/train_vocab.py) and cross-scene AP did NOT improve (0.048).
This study tests the remaining hypothesis directly: procedural textures
are SCENE-IDIOSYNCRATIC — their local-patch statistics differ per seed,
so no disjoint-seed corpus can place the eval scene's descriptors in
discriminative leaves — while natural imagery shares universal local
statistics (the reason the reference can ship one generic ~100 MB DBoW3
artifact, main.cpp:67).

Protocol (identical across domains):
  * a domain is a set of images: NATURAL = the 5 dense-map screenshots
    shipped in the reference repo (`Tests/Selection_006..010.png`, real
    ICL/TUM scene appearance; PUBLIC content used as image data only);
    PROCEDURAL = 5 hard-synthetic renders (one frame per disjoint seed).
  * "places" are random 320x240 crops; each place yields 2 views via
    affine warp + photometric jitter; revisit detection = distinguishing
    same-place view pairs from different-place pairs by BoW L1 score.
  * TRANSFER vocabulary: trained on descriptors from the other images of
    the domain (held-out);  ORACLE vocabulary: trained on the eval
    images themselves (the in-run upper bound).
  * Reported per domain: AP_transfer, AP_oracle, and their ratio — the
    transfer gap, isolated from everything else.

Usage:
  JAX_PLATFORMS=cpu python scripts/vocab_transfer_study.py
Appends results to docs/VOCAB_STUDY.md (--out).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax.numpy as jnp  # noqa: E402

from aslam.config import SystemConfig, CameraModel  # noqa: E402
from aslam.models import frame as frame_mod  # noqa: E402
from aslam.models.extractor import init_adaptive_state  # noqa: E402
from aslam.ops import bow  # noqa: E402

CROP_H, CROP_W = 240, 320


def _load_natural(natural_dir: str) -> list[np.ndarray]:
    from aslam.utils.dataset import load_rgb_gray

    return [load_rgb_gray(os.path.join(natural_dir, f"Selection_{n:03d}.png"))
            for n in range(6, 11)]


def _render_procedural(n: int = 5) -> list[np.ndarray]:
    from aslam.utils import synthetic_hard as sh

    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                      width=640, height=480)
    out = []
    for seed in range(n):
        imgs, _, _ = sh.make_hard_sequence(cam, kind="loop", n_frames=2,
                                           seed=seed)
        out.append(imgs[0].astype(np.float32))
    return out


def _augment(crop: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Affine warp + photometric jitter of a place crop."""
    h, w = crop.shape
    ang = rng.uniform(-0.25, 0.25)
    s = rng.uniform(0.9, 1.12)
    ca, sa = np.cos(ang) * s, np.sin(ang) * s
    Ainv = np.linalg.inv(np.array([[ca, -sa], [sa, ca]]))
    cx, cy = w / 2, h / 2
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    sx = Ainv[0, 0] * (xx - cx) + Ainv[0, 1] * (yy - cy) + cx
    sy = Ainv[1, 0] * (xx - cx) + Ainv[1, 1] * (yy - cy) + cy
    x0 = np.clip(np.floor(sx).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(np.int32), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    v = ((1 - fy) * ((1 - fx) * crop[y0, x0] + fx * crop[y0, x0 + 1])
         + fy * ((1 - fx) * crop[y0 + 1, x0] + fx * crop[y0 + 1, x0 + 1]))
    gain = rng.uniform(0.7, 1.3)
    bias = rng.uniform(-15, 15)
    v = v * gain + bias + rng.normal(0, 2.0, v.shape)
    return np.clip(v, 0, 255).astype(np.float32)


def _crops(img: np.ndarray, n: int, rng: np.random.Generator):
    h, w = img.shape
    out = []
    for _ in range(n):
        y = rng.integers(0, max(h - CROP_H, 1))
        x = rng.integers(0, max(w - CROP_W, 1))
        out.append(img[y:y + CROP_H, x:x + CROP_W])
    return out


def _extract(img: np.ndarray, cfg) -> np.ndarray:
    st = init_adaptive_state(cfg.extractor)
    dep = np.full(img.shape, 2.0, np.float32)   # depth unused for desc
    f, _ = frame_mod.make_frame(jnp.asarray(img), jnp.asarray(dep), cfg, st)
    return np.asarray(f.feat.desc)[np.asarray(f.feat.valid)]


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(-scores)
    lab = labels[order]
    tp = np.cumsum(lab)
    prec = tp / (np.arange(len(lab)) + 1)
    return float((prec * lab).sum() / max(lab.sum(), 1))


def run_domain(name: str, images: list[np.ndarray], cfg, n_places: int,
               rng: np.random.Generator):
    n_eval = 2
    eval_imgs, train_imgs = images[:n_eval], images[n_eval:]

    # eval set: places + two augmented views each
    views, place_id = [], []
    for i, im in enumerate(eval_imgs):
        for p, crop in enumerate(_crops(im, n_places, rng)):
            pid = i * n_places + p
            for _ in range(2):
                views.append(_augment(crop, rng))
                place_id.append(pid)
    desc_views = [_extract(v, cfg) for v in views]
    place_id = np.asarray(place_id)

    def vocab_from(imgs_for_training):
        pool = []
        for im in imgs_for_training:
            for crop in _crops(im, n_places, rng):
                pool.append(_extract(_augment(crop, rng), cfg))
        d = np.concatenate(pool)
        if len(d) > 60000:
            d = d[rng.choice(len(d), 60000, replace=False)]
        return bow.train_vocabulary(d, branching=10, depth=4)

    def score_all(vocab):
        vecs = []
        for d in desc_views:
            if len(d) == 0:
                vecs.append(np.zeros(vocab.n_words, np.float32))
                continue
            words = bow.transform(vocab, jnp.asarray(d))
            v = bow.bow_vector(vocab, words,
                               jnp.ones(len(d), bool))
            vecs.append(np.asarray(v))
        V = np.stack(vecs)
        n = len(V)
        scores, labels = [], []
        for i in range(n):
            for j in range(i + 1, n):
                # L1 similarity (DBoW3 score shape)
                scores.append(2 - np.abs(V[i] - V[j]).sum())
                labels.append(place_id[i] == place_id[j])
        return np.asarray(scores), np.asarray(labels)

    out = {}
    for mode, tr in (("transfer", train_imgs), ("oracle", eval_imgs)):
        vocab = vocab_from(tr)
        s, l = score_all(vocab)
        out[mode] = average_precision(s, l)
        print(f"{name:>10} {mode}: AP={out[mode]:.3f} "
              f"({int(l.sum())} same-place / {len(l)} pairs)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--places", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--natural-dir", required=True,
                    help="the reference repository's Tests/ directory "
                    "(Selection_006.png ... Selection_010.png)")
    ap.add_argument("--out", default=os.path.join(REPO, "docs",
                                                  "VOCAB_STUDY.md"))
    args = ap.parse_args(argv)

    cfg = SystemConfig(camera=CameraModel(
        fx=258.6, fy=258.2, cx=159.3, cy=127.6,
        width=CROP_W, height=CROP_H))
    rng = np.random.default_rng(args.seed)

    nat = run_domain("natural", _load_natural(args.natural_dir), cfg,
                     args.places, rng)
    pro = run_domain("procedural", _render_procedural(), cfg, args.places,
                     rng)

    ratio_nat = nat["transfer"] / max(nat["oracle"], 1e-9)
    ratio_pro = pro["transfer"] / max(pro["oracle"], 1e-9)
    lines = [
        "",
        "## Transfer study: natural vs procedural imagery (round 4)",
        "",
        "Identical protocol per domain (places = random crops, 2 "
        "warp+photometric views each, vocabulary trained on HELD-OUT "
        "images vs on the eval images themselves; "
        "scripts/vocab_transfer_study.py):",
        "",
        "| domain | AP transfer | AP oracle | transfer/oracle |",
        "|---|---|---|---|",
        f"| natural (reference repo screenshots) | {nat['transfer']:.3f} "
        f"| {nat['oracle']:.3f} | {ratio_nat:.2f} |",
        f"| procedural (hard-synthetic renders) | {pro['transfer']:.3f} "
        f"| {pro['oracle']:.3f} | {ratio_pro:.2f} |",
        "",
    ]
    print("\n".join(lines), flush=True)
    with open(args.out, "a") as f:
        f.write("\n".join(lines) + "\n")
    print(f"appended to {args.out}")


if __name__ == "__main__":
    main()
