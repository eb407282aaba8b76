"""Vocabulary quality study: loop-detection recall/precision vs vocabulary
size, plus node-level vs leaf-level BoW-guided match counts.

Method: render a hard textured loop sequence (ground-truth poses known),
extract features with the production front-end, define TRUE REVISITS as
frame pairs with id gap > `gap` and pose within (0.35 m, 0.35 rad).  For
each vocabulary shape, train on the first quarter of the sequence (the
same early-training regime the live system uses), score ALL gap>40 pairs
with the DBoW3 L1 metric, and sweep a threshold to get a precision-recall
curve.  Reported: AUC (average precision), recall at precision >= 0.9,
and — for the 5 closest true revisit pairs — the number of BoW-guided
matches under leaf bucketing vs 1-level-up node bucketing
(cfg.loop.match_node_levels; the reference buckets by level-up-4 nodes of
its DBoW3 tree, frame.cpp:187, matcher.cpp:147-210).

Usage:
  JAX_PLATFORMS=cpu python scripts/vocab_study.py --frames 120 [--small]
Writes docs/VOCAB_STUDY.md.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aslam.config import TUM_FR1, SystemConfig, small_config  # noqa: E402
from aslam.models import frame as frame_mod  # noqa: E402
from aslam.models.extractor import init_adaptive_state  # noqa: E402
from aslam.ops import bow  # noqa: E402
from aslam.ops.hamming import INVALID_DIST, masked_distance_matrix  # noqa: E402
from aslam.utils import synthetic_hard as sh  # noqa: E402


def pose_dist(Ta, Tb):
    d = np.linalg.inv(Ta) @ Tb
    dt = np.linalg.norm(d[:3, 3])
    dr = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
    return dt, dr


def guided_match_count(desc_a, valid_a, words_a, desc_b, valid_b, words_b,
                       node_div, th_low=50.0, ratio=0.75):
    d = masked_distance_matrix(desc_a, valid_a, desc_b, valid_b)
    same = (words_a[:, None] // node_div) == (words_b[None, :] // node_div)
    d = jnp.where(same, d, INVALID_DIST)
    neg, idx = jax.lax.top_k(-d, 2)
    d1, d2 = -neg[:, 0], -neg[:, 1]
    ok = (d1 <= th_low) & (d1 < ratio * d2)
    return int(jnp.sum(ok))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--gap", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default="docs/VOCAB_STUDY.md")
    ap.add_argument("--vocab-path", default="",
                    help="also score the pretrained artifact at this path "
                         "(trained on DISJOINT scene seeds)")
    ap.add_argument("--pretrained-only", action="store_true",
                    help="skip the in-run-trained shapes (append mode: "
                         "keeps docs table regeneration cheap)")
    args = ap.parse_args(argv)

    cfg = small_config() if args.small else SystemConfig(camera=TUM_FR1)
    imgs, depths, gt = sh.make_hard_sequence(
        cfg.camera, kind="loop", n_frames=args.frames, seed=args.seed)
    F = args.frames
    print(f"rendered {F} frames", flush=True)

    st = init_adaptive_state(cfg.extractor)
    descs, valids = [], []
    for i in range(F):
        f, st = frame_mod.make_frame(jnp.asarray(imgs[i]),
                                     jnp.asarray(depths[i]), cfg, st)
        descs.append(np.asarray(f.feat.desc))
        valids.append(np.asarray(f.feat.valid))
    print("extracted", flush=True)

    # ground-truth revisit labels over gap>thr pairs
    pairs, labels = [], []
    for i in range(F):
        for j in range(i + args.gap, F):
            dt, dr = pose_dist(gt[i], gt[j])
            pairs.append((i, j))
            labels.append(dt < 0.35 and dr < 0.35)
    labels = np.asarray(labels)
    print(f"{labels.sum()} true revisits / {len(pairs)} gap>{args.gap} pairs")

    train = np.concatenate(
        [descs[i][valids[i]] for i in range(F // 4)])
    if len(train) > 20000:
        train = train[np.random.default_rng(0).choice(
            len(train), 20000, replace=False)]

    rows = []
    match_rows = []
    true_pairs = [pairs[k] for k in np.nonzero(labels)[0]]
    # 5 closest true pairs by translation distance
    true_pairs.sort(key=lambda ij: pose_dist(gt[ij[0]], gt[ij[1]])[0])
    probe_pairs = true_pairs[:5]

    shapes = [((10, 2), None), ((4, 4), None), ((10, 3), None),
              ((10, 4), None)]
    if args.pretrained_only:
        shapes = []
    if args.vocab_path:
        pre = bow.load_vocabulary(args.vocab_path)
        shapes.append(
            ((pre.branching, pre.depth), pre))

    for (B, D), pre in shapes:
        W = B ** D
        vocab = pre if pre is not None else bow.train_vocabulary(
            train, branching=B, depth=D)
        words = [np.asarray(bow.transform(vocab, jnp.asarray(d)))
                 for d in descs]
        vecs = np.stack([
            np.asarray(bow.bow_vector(vocab, jnp.asarray(words[i]),
                                      jnp.asarray(valids[i])))
            for i in range(F)
        ])
        scores = np.asarray([
            1.0 - 0.5 * np.abs(vecs[i] - vecs[j]).sum()
            for i, j in pairs
        ])
        # average precision + recall at precision 0.9
        order = np.argsort(-scores)
        tp = np.cumsum(labels[order])
        fp = np.cumsum(~labels[order])
        prec = tp / np.maximum(tp + fp, 1)
        rec = tp / max(labels.sum(), 1)
        ap_score = float(np.sum(np.diff(np.concatenate([[0.0], rec]))
                                * prec))
        ok = prec >= 0.9
        r_at_p90 = float(rec[ok].max()) if ok.any() else 0.0
        name = f"{B}^{D}={W}" + (" (pretrained)" if pre is not None else "")
        rows.append((name, ap_score, r_at_p90))
        print(f"vocab {name}: AP={ap_score:.3f} R@P90={r_at_p90:.3f}",
              flush=True)

        if (B, D) == (10, 3) and pre is None:  # match-level comparison
            for i, j in probe_pairs:
                n_leaf = guided_match_count(
                    jnp.asarray(descs[i]), jnp.asarray(valids[i]),
                    jnp.asarray(words[i]),
                    jnp.asarray(descs[j]), jnp.asarray(valids[j]),
                    jnp.asarray(words[j]), node_div=1)
                n_node = guided_match_count(
                    jnp.asarray(descs[i]), jnp.asarray(valids[i]),
                    jnp.asarray(words[i]),
                    jnp.asarray(descs[j]), jnp.asarray(valids[j]),
                    jnp.asarray(words[j]), node_div=B)
                match_rows.append((i, j, n_leaf, n_node))
                print(f"pair ({i},{j}): leaf={n_leaf} node(1up)={n_node}",
                      flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(
            "# Vocabulary quality study\n\n"
            f"Hard textured loop, {F} frames, revisit = gap>{args.gap} & "
            "pose within (0.35 m, 0.35 rad); vocabulary trained on the "
            "first quarter of the sequence (the live early-training "
            "regime).  Generated by scripts/vocab_study.py.\n\n"
            "| vocabulary | average precision | recall @ precision 0.9 |\n"
            "|---|---|---|\n")
        for name, ap_s, r in rows:
            f.write(f"| {name} | {ap_s:.3f} | {r:.3f} |\n")
        f.write(
            "\n## BoW-guided match counts (true revisit pairs, 10^3 vocab)\n\n"
            "| pair | leaf-equality matches | 1-up node matches |\n"
            "|---|---|---|\n")
        for i, j, nl, nn in match_rows:
            f.write(f"| ({i},{j}) | {nl} | {nn} |\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
