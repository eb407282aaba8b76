"""Micro-benchmark: landmark-block accumulation strategies.

The map-scale BA sweeps (ops/global_ba.py) accumulate per-edge 3x3/3x1
normal-equation blocks into per-landmark rows.  The natural formulation is
a scatter-add (`.at[lm].add(v)`), which resolves duplicate indices with
atomics (and in a different sum order than the CPU).  Candidate
replacement: sort-free two-pass segment reduction —

  1. sort edge values by landmark id (one argsort per problem, reusable
     across iterations because kf_lm is fixed during BA),
  2. inclusive cumsum over the sorted values,
  3. per-landmark result = cumsum[end_l] - cumsum[start_l]  (pure gathers).

Run:  python scripts/scatter_bench.py [--edges 2621440] [--lms 655360]
Prints ms/call for each strategy and the max abs difference.
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def time_call(fn, *args, n=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n * 1e3, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, default=2_621_440)
    ap.add_argument("--lms", type=int, default=655_360)
    ap.add_argument("--width", type=int, default=12,
                    help="floats per edge value (3x3 block + 3 vector)")
    args = ap.parse_args()

    E, L, W = args.edges, args.lms, args.width
    rng = np.random.default_rng(0)
    # realistic distribution: landmark ids cluster (covisible KFs see the
    # same landmarks), ~E/L mean multiplicity with hot spots
    lm = np.clip(
        (rng.random(E) ** 1.5 * L).astype(np.int32), 0, L - 1)
    vals = rng.standard_normal((E, W)).astype(np.float32)
    lm_d = jnp.asarray(lm)
    vals_d = jnp.asarray(vals)

    @jax.jit
    def scatter_add(lm, v):
        return jnp.zeros((L, W)).at[lm].add(v)

    # one-time (per BA problem) preprocessing: sort permutation + segment
    # boundaries.  kf_lm is constant through a BA solve, so this amortizes
    # over every sweep/CG iteration.
    @jax.jit
    def preprocess(lm):
        perm = jnp.argsort(lm)
        sorted_lm = lm[perm]
        # start[l] = first index with id >= l ; end[l] = first > l
        idx = jnp.arange(L)
        start = jnp.searchsorted(sorted_lm, idx, side="left")
        end = jnp.searchsorted(sorted_lm, idx, side="right")
        return perm, start, end

    @jax.jit
    def seg_cumsum(perm, start, end, v):
        s = jnp.cumsum(v[perm], axis=0, dtype=jnp.float32)
        s = jnp.concatenate([jnp.zeros((1, W), s.dtype), s], axis=0)
        return s[end] - s[start]

    @jax.jit
    def seg_sum_sorted(perm, v):
        # jax segment_sum on pre-sorted ids (XLA may pick a better expander)
        sv = v[perm]
        slm = lm_d[perm]
        return jax.ops.segment_sum(sv, slm, num_segments=L,
                                   indices_are_sorted=True)

    ms_scatter, ref = time_call(scatter_add, lm_d, vals_d)
    ms_pre, (perm, start, end) = time_call(preprocess, lm_d, n=3)
    ms_cumsum, out1 = time_call(seg_cumsum, perm, start, end, vals_d)
    ms_seg, out2 = time_call(seg_sum_sorted, perm, vals_d)

    err1 = float(jnp.max(jnp.abs(out1 - ref)))
    err2 = float(jnp.max(jnp.abs(out2 - ref)))
    print(f"edges={E} landmarks={L} width={W}")
    print(f"scatter_add               : {ms_scatter:8.2f} ms/call")
    print(f"preprocess (1x per solve) : {ms_pre:8.2f} ms")
    print(f"sorted cumsum-diff        : {ms_cumsum:8.2f} ms/call  "
          f"(max|diff| {err1:.2e})")
    print(f"sorted segment_sum        : {ms_seg:8.2f} ms/call  "
          f"(max|diff| {err2:.2e})")


if __name__ == "__main__":
    main()
