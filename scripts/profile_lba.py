"""Micro-profile of the windowed local-BA solver and the local-map
tracking internals (VERDICT r5 tasks 1-2) — chained-carry scan timing with
completion reads, on a fabricated corridor map (no session growth needed).

Usage:  python scripts/profile_lba.py [--kfs 1024] [--n 16]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(label, fn, state, n=16, reps=2):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(s):
        def body(c, _):
            return fn(c), 0
        out, _ = jax.lax.scan(body, s, None, length=n)
        return out

    out = run(state)
    leaf = jax.tree_util.tree_leaves(out)[0]
    _ = float(jnp.sum(jnp.asarray(leaf, jnp.float32).ravel()[:16]))
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        out = run(state)
        leaf = jax.tree_util.tree_leaves(out)[0]
        _ = float(jnp.sum(jnp.asarray(leaf, jnp.float32).ravel()[:16]))
        best = min(best, (time.time() - t0) / n)
    print(f"  {label:22s} {best * 1e3:8.3f} ms/iter", flush=True)
    return best * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=1024)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--feats", type=int, default=512)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from aslam.config import (BAConfig, CameraModel, ExtractorConfig,
                                  MapConfig, SystemConfig)
    from aslam.models import localmapping as lm
    from aslam.models import mapstate as ms
    from aslam.ops import lba as lba_mod
    from aslam.workloads import build_corridor_map

    cam = CameraModel(fx=258.6, fy=258.2, cx=159.3, cy=127.6,
                      width=320, height=240)
    cfg = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(n_features=args.feats,
                                  max_keypoints=args.feats),
        map=MapConfig(max_keyframes=args.kfs,
                      max_landmarks=max(args.kfs * 64, 16384)),
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192),
        use_loop_closing=False,
    )
    print("devices:", jax.devices(), flush=True)
    m, _, _ = build_corridor_map(cfg, args.kfs, args.feats)
    # give landmarks random descriptors so Hamming paths do real work
    rng = np.random.default_rng(0)
    m = m._replace(
        lm_desc=jnp.asarray(
            rng.integers(0, 2**32, m.lm_desc.shape, dtype=np.uint32)),
        kf_desc=jnp.asarray(
            rng.integers(0, 2**32, m.kf_desc.shape, dtype=np.uint32)),
    )
    slot = jnp.int32(args.kfs - 1)
    n = args.n

    spec = lm.build_window(m, slot, cfg)
    prob0, lw_ids = lm.build_problem(m, spec, cfg)[:2]
    chain0 = lm.build_chain(m, spec, cfg)
    print(f"window: C={prob0.cam_T.shape[0]} Lw={prob0.points.shape[0]} "
          f"E={prob0.e_cam.shape[0]}", flush=True)

    print("\n--- LBA internals ---", flush=True)

    def full_lba(p):
        p2, _ = lba_mod.local_ba(p, cfg.camera, cfg.ba, chain=chain0)
        return p2
    timed("local_ba (5+prune+10)", full_lba, prob0, n)

    def one_iter(p):
        return lba_mod.ba_iterate(p, cfg.camera, cfg.ba, 1, robust=True,
                                  chain=chain0)
    timed("ba_iterate x1", one_iter, prob0, n)

    def asm(p):
        Hcc, bc, Hll, bl, W, chi2 = lba_mod.assemble(
            p, cfg.camera, cfg.ba, True)
        # fold outputs back into carry to defeat hoisting
        return p._replace(points=p.points + 1e-12 * bl[:p.points.shape[0]])
    timed("assemble", asm, prob0, n)

    def edges_only(p):
        r, Jc, Jp, w, chi2, active = lba_mod.edge_terms(
            p, cfg.camera, cfg.ba, True)
        return p._replace(points=p.points + 1e-12 * chi2.sum())
    timed("edge_terms", edges_only, prob0, n)

    Hcc, bc, Hll, bl, W, _ = lba_mod.assemble(prob0, cfg.camera, cfg.ba, True)
    Hch, bch, _ = lba_mod.chain_terms(prob0.cam_T, chain0)

    def solve_only(carry):
        Hcc_, bc_ = carry
        dxc, dxl = lba_mod.schur_solve(
            Hcc_, bc_, Hll, bl, W, prob0.cam_fixed, prob0.point_valid,
            1e-4, H_chain=Hch, b_chain=bch)
        return (Hcc_ + 1e-12 * dxc[:, None, :] * dxc[:, :, None],
                bc_ + 1e-12 * dxc)
    timed("schur_solve", solve_only, (Hcc, bc), n)

    # the dense reduced-camera solve alone
    C = Hcc.shape[0]
    S0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (C * 6, C * 6)))
    S0 = S0 @ S0.T + 10.0 * np.eye(C * 6)
    S0 = jnp.asarray(S0.astype(np.float32))
    rhs0 = jnp.asarray(np.ones(C * 6, np.float32))

    def lin_solve(carry):
        S, r = carry
        x = jnp.linalg.solve(S, r)
        return (S + 1e-12 * x[:, None] * x[None, :], r + 1e-12 * x)
    timed(f"linalg.solve {C*6}x{C*6}", lin_solve, (S0, rhs0), n)

    def cho_solve(carry):
        S, r = carry
        x = jax.scipy.linalg.cho_solve(
            (jax.scipy.linalg.cholesky(S, lower=True), True), r)
        return (S + 1e-12 * x[:, None] * x[None, :], r + 1e-12 * x)
    timed(f"cho_solve {C*6}x{C*6}", cho_solve, (S0, rhs0), n)

    def w_scatter(p):
        r, Jc, Jp, w, chi2, active = lba_mod.edge_terms(
            p, cfg.camera, cfg.ba, True)
        wJc = w[:, None, None] * Jc
        L = p.points.shape[0]
        W_ = jnp.zeros((C, L, 6, 3)).at[p.e_cam, p.e_lm].add(
            jnp.einsum("eri,erj->eij", wJc, Jp))
        return p._replace(points=p.points + 1e-12 * W_.sum((0, 2, 3))[:, None])
    timed("edge_terms+W scatter", w_scatter, prob0, n)

    def s_matmul(carry):
        W_, = carry
        from aslam.ops.linalg import chol_inv
        Hll_inv = chol_inv(Hll + jnp.eye(3) * 1e-3)
        Y = jnp.einsum("clij,ljk->clik", W_, Hll_inv)
        S = -jnp.einsum("clik,dljk->cidj", Y, W_,
                        preferred_element_type=jnp.float32)
        return (W_ + 1e-12 * S.sum((1, 2, 3))[:, None, None, None],)
    timed("Y + S einsums", s_matmul, (W,), n)

    # ---------------- local-map tracking internals ----------------
    print("\n--- track_local_map internals ---", flush=True)
    from aslam.ops import matching
    from aslam.ops import ba as ba_mod
    from aslam.utils import camera as camera_mod

    L = m.lm_pos.shape[0]
    M = args.feats
    assoc = jnp.asarray(np.where(rng.random(M) < 0.5,
                                 rng.integers(0, L, M), -1).astype(np.int32))
    T_frame = m.kf_T_cw[slot]

    def votes_fn(a):
        cur = jnp.zeros((L + 1,), bool).at[
            jnp.where(a >= 0, a, L)].set(True)[:L]
        v = ms.kf_votes(m, cur)
        # data-dependent fold (runtime 0) so XLA cannot DCE the body
        return a + (v.sum() // (2**30)).astype(jnp.int32)
    timed("kf_votes", votes_fn, assoc, n)

    def frustum_fn(a):
        vis, pred_uv, _, _ = camera_mod.in_frustum(cam, T_frame, m.lm_pos)
        return a + ((vis.sum() + pred_uv.sum().astype(jnp.int32))
                    // (2**30)).astype(jnp.int32)
    timed(f"in_frustum L={L}", frustum_fn, assoc, n)

    cand0 = np.zeros(L, bool)
    cand0[rng.integers(0, L, 4000)] = True
    cand_j = jnp.asarray(cand0)

    def compact_fn(a):
        cidx, cvalid, nov = matching.compact_candidates(
            cand_j ^ (a[0] < -10**8), min(cfg.map.proj_match_cap, L))
        return a + (cidx.sum() // (2**30)).astype(jnp.int32)
    timed(f"compact_candidates", compact_fn, assoc, n)

    cap = min(cfg.map.proj_match_cap, L)
    cidx, cvalid, _ = matching.compact_candidates(cand_j, cap)
    pred_uv = jnp.asarray(rng.uniform(0, 320, (cap, 2)).astype(np.float32))
    f_xy = jnp.asarray(rng.uniform(0, 320, (M, 2)).astype(np.float32))
    f_desc = jnp.asarray(rng.integers(0, 2**32, (M, 8), dtype=np.uint32))
    f_val = jnp.ones((M,), bool)
    f_oct = jnp.zeros((M,), jnp.int32)

    def pm_fn(a):
        pm = matching.projection_match(
            m.lm_desc[cidx], cvalid, pred_uv, f_xy, f_desc, f_val, f_oct,
            a < 0, radius=cfg.matcher.proj_radius,
            th_high=float(cfg.matcher.th_high),
            ratio=cfg.matcher.ratio_local)
        return a + (pm.valid.sum() // (2**30)).astype(jnp.int32)
    timed(f"projection_match cap={cap}", pm_fn, assoc, n)

    pts_w = jnp.asarray(rng.uniform(-1, 1, (M, 3)).astype(np.float32))
    obs_valid = jnp.asarray(rng.random(M) < 0.5)
    f_ur = jnp.asarray(rng.uniform(-1, 320, M).astype(np.float32))
    f_z = jnp.asarray(rng.uniform(0.5, 3, M).astype(np.float32))

    def pba_fn(carry):
        T0 = carry
        res = ba_mod.pose_only_ba(T0, pts_w, f_xy, f_ur, f_z, obs_valid,
                                  cam, cfg.ba, prior_weight=1.0)
        return res.T_cw
    timed("pose_only_ba (4x10)", pba_fn, T_frame, n)


if __name__ == "__main__":
    main()
