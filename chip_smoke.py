"""On-card smoke test: drives the RGB-D SLAM engine's main path once, at
full width, on one NVIDIA GPU, and checks what comes out.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: phase 6 only

Phases (each a plain function, so the CPU tests call them at
`workloads.small_config()`):

  1. device   - JAX must see a GPU; prints devices, JAX version, the
                card's name and power limit, XLA_FLAGS and the compile cache.
  2. parity   - make_frame -> knn_ratio_match -> rba_step on one frame
                pair, and one local BA at the bench window, each on the
                GPU and on the host CPU with the same inputs.
  3. vo       - odometry.track_sequence over 64-frame chunks; ATE gate.
  4. slam     - DeviceSlam.process_chunk over the 257-frame walk; ATE
                gate, at least one keyframe mapped.
  5. cli      - `aslam.main` with --engine device --mode slam+loop on an
                on-disk TUM-layout sequence, in this process; ATE gate.
  6. four     - sharded GN-CG, sharded local BA and the session's sharded
                post-loop GBA on a 4-card mesh against one card.

Matmul precision: `aslam` pins jax_default_matmul_precision to float32, so
no f32 matmul runs in TF32; every tolerance below holds under it.

A failed check raises, the process exits non-zero and the result line is
not printed.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ATE_LIMIT_M = 0.010

_compile_s = [0.0]


def _on_duration(name: str, secs: float, **_):
    if name.startswith("/jax/core/compile/"):
        _compile_s[0] += secs


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_label() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines() if ln.strip())


def phase_device(n_cards: int) -> str:
    """Phase 1.  Exits (non-zero) unless JAX's backend is the GPU with
    exactly `n_cards` devices.  Returns the card label."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not "
                         "'gpu'; nothing was run")
    if len(jax.devices()) != n_cards:
        raise SystemExit(f"chip_smoke: needs exactly {n_cards} GPU(s), JAX "
                         f"sees {len(jax.devices())}")
    import aslam

    label = card_label()
    print(f"devices: {jax.devices()}  jax {jax.__version__}")
    print(f"card: {label}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {aslam.CACHE_DIR}")
    print("matmul precision: "
          f"{jax.config.jax_default_matmul_precision}")
    return label


# ---------------------------------------------------------------- parity


def hamming_reference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain NumPy Hamming distances [Na,Nb] of packed uint32 [N,8]."""
    bits_a = np.unpackbits(np.ascontiguousarray(a).view(np.uint8), axis=1)
    bits_b = np.unpackbits(np.ascontiguousarray(b).view(np.uint8), axis=1)
    ia, ib = bits_a.astype(np.int64), bits_b.astype(np.int64)
    return ia @ (1 - ib).T + (1 - ia) @ ib.T


def _device_timing(fn, args, n: int = 100) -> float:
    """Seconds per call of `fn` in a warm on-device loop of `n` calls; the
    first argument is rolled by one row per call so no call is hoisted."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*a):
        def body(i, acc):
            out = fn(jnp.roll(a[0], i, axis=0), *a[1:])
            return acc + jnp.sum(out.distance)
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    jax.block_until_ready(loop(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(loop(*args))
    return (time.perf_counter() - t0) / n


def _rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle of Ra Rb^T.  atan2 of the skew part against the trace: the
    arccos of the trace alone turns float32 non-orthonormality (~1e-7)
    into ~5e-4 rad."""
    D = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = 0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                              D[1, 0] - D[0, 1]])
    return float(np.arctan2(s, 0.5 * (np.trace(D) - 1.0)))


def lba_problem(cfg):
    """A local-BA problem at `cfg`'s full window, cut from a corridor map of
    `max_keyframes` keyframes x `max_keypoints` features, as the mapper
    builds it (window, compact landmarks, odometry chain)."""
    import jax

    from aslam import workloads
    from aslam.models import localmapping as lm

    K, M = cfg.map.max_keyframes, cfg.extractor.max_keypoints
    m, _, _ = workloads.build_corridor_map(cfg, K, M)

    @jax.jit
    def build(m):
        spec = lm.build_window(m, jax.numpy.int32(K // 2), cfg)
        prob, _, _ = lm.build_problem(m, spec, cfg)
        return prob, lm.build_chain(m, spec, cfg)

    prob, chain = build(m)
    return prob, chain, M


def phase_parity(cfg, dev, ref) -> dict:
    """Phase 2: each front-end stage and one local BA on `dev` and on `ref`
    (the host CPU) with identical inputs and keys."""
    import jax
    import jax.numpy as jnp

    from aslam import workloads
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.models.odometry import rba_step
    from aslam.ops import lba, matching
    from aslam.ops.hamming import masked_distance_matrix

    cam = cfg.camera
    imgs, deps, poses = workloads.vo_sequence(cam, 2)
    key = jax.random.PRNGKey(3)

    def run(device, fn, *args):
        with jax.default_device(device):
            return jax.device_get(fn(*jax.device_put(args, device)))

    def frames(img0, dep0, img1, dep1, T0):
        st = init_adaptive_state(cfg.extractor)
        f0, st = frame_mod.make_frame(img0, dep0, cfg, st)
        f1, _ = frame_mod.make_frame(img1, dep1, cfg, st)
        return frame_mod.with_pose(f0, T0), f1

    inputs = (imgs[0], deps[0], imgs[1], deps[1], poses[0])
    fg = run(dev, frames, *inputs)
    fc = run(ref, frames, *inputs)

    # keypoints: same octave and position (to 1e-3 px: the sub-pixel
    # parabola may round differently), then the same descriptor
    def kp_parity(a, b):
        va, vb = np.asarray(a.feat.valid), np.asarray(b.feat.valid)
        xa, xb = np.asarray(a.feat.xy)[va], np.asarray(b.feat.xy)[vb]
        oa, ob = np.asarray(a.feat.octave)[va], np.asarray(b.feat.octave)[vb]
        da, db = np.asarray(a.feat.desc)[va], np.asarray(b.feat.desc)[vb]
        if not (len(xa) and len(xb)):
            return max(len(xa), len(xb)), 0, 0
        dist = np.abs(xa[:, None, :] - xb[None, :, :]).max(-1)
        dist = np.where(oa[:, None] == ob[None, :], dist, np.inf)
        j = np.argmin(dist, axis=1)
        near = dist[np.arange(len(xa)), j] <= 1e-3
        same = near & (da == db[j]).all(-1)
        return max(len(xa), len(xb)), int(near.sum()), int(same.sum())
    n_kp = n_near = n_same = 0
    for a, b in ((fg[0], fc[0]), (fg[1], fc[1])):
        n, k, s_ = kp_parity(a, b)
        n_kp, n_near, n_same = n_kp + n, n_near + k, n_same + s_
    kp_share = n_same / max(n_kp, 1)
    print(f"parity make_frame: {n_same}/{n_kp} keypoints identical "
          f"({n_kp - n_near} at another position, {n_near - n_same} with "
          f"another descriptor), share {kp_share:.4f} (limit >= 0.99)")
    check(n_kp > 0 and kp_share >= 0.99, "keypoint parity")

    # matcher on the same packed descriptors: bit-exact on both devices
    f0, f1 = fg

    def match(dq, vq, dt, vt):
        d = masked_distance_matrix(dq, vq, dt, vt)
        m = matching.knn_ratio_match(dq, vq, dt, vt,
                                     ratio=cfg.matcher.ratio_frame,
                                     max_dist=float(cfg.matcher.th_high))
        _, i1, _, i2 = matching._top2(d)
        return d, i1, i2, m
    margs = (f0.feat.desc, f0.feat.valid, f1.feat.desc, f1.feat.valid)
    dg, i1g, i2g, mg = run(dev, match, *margs)
    dc, i1c, i2c, mc = run(ref, match, *margs)
    ok = np.asarray(f0.feat.valid)[:, None] & np.asarray(f1.feat.valid)[None]
    d_ref = hamming_reference(np.asarray(f0.feat.desc),
                              np.asarray(f1.feat.desc))
    d_err = float(np.max(np.abs(np.where(ok, dg - d_ref, 0.0))))
    n_idx = int(np.sum(i1g != i1c) + np.sum(i2g != i2c))
    n_match = int(np.sum(mg.target_idx != mc.target_idx))
    print(f"parity knn_ratio_match [{len(dg)}x{dg.shape[1]}]: max|d_gpu - "
          f"d_cpu| {float(np.max(np.abs(dg - dc))):.1f}, max|d_gpu - "
          f"popcount| {d_err:.1f}, top-2 index mismatches {n_idx}, match "
          f"mismatches {n_match} (limit: all 0)")
    check(np.array_equal(dg, dc) and d_err == 0.0 and n_idx == 0
          and n_match == 0, "matcher bit-exact")

    # rba_step on the same frames and key
    rg = run(dev, lambda a, b, k: rba_step(a, b, k, cfg), f0, f1, key)
    rc = run(ref, lambda a, b, k: rba_step(a, b, k, cfg), f0, f1, key)
    dt = float(np.linalg.norm(rg.T_cw2[:3, 3] - rc.T_cw2[:3, 3]))
    dr = _rot_angle(rg.T_cw2[:3, :3], rc.T_cw2[:3, :3])
    print(f"parity rba_step: |dt| {dt:.3e} m, |dR| {dr:.3e} rad "
          f"(limits 1e-4), inliers {int(rg.n_inliers)} vs "
          f"{int(rc.n_inliers)}")
    check(dt <= 1e-4 and dr <= 1e-4, "rba_step pose parity")

    # one local BA at the full window, as the mapper calls it
    prob, chain, group = lba_problem(cfg)

    def solve(p, c):
        return lba.local_ba(p, cam, cfg.ba, chain=c, group=group)
    pg, sg = run(dev, solve, prob, chain)
    pc, sc = run(ref, solve, prob, chain)
    rel = abs(float(sg.chi2) - float(sc.chi2)) / max(abs(float(sc.chi2)),
                                                     1e-12)
    print(f"parity local_ba [C={prob.cam_T.shape[0]} "
          f"Lw={prob.points.shape[0]} E={prob.e_cam.shape[0]}, "
          f"{int(sg.n_edges)} active edges]: chi2 {float(sg.chi2):.6e} vs "
          f"{float(sc.chi2):.6e}, rel {rel:.2e} (limit 1e-3); max|dT| "
          f"{float(np.max(np.abs(pg.cam_T - pc.cam_T))):.2e}, max|dX| "
          f"{float(np.max(np.abs(pg.points - pc.points))):.2e}")
    check(int(sg.n_edges) > 0 and rel <= 1e-3, "local_ba chi2 parity")

    # matcher device times: the bar a fused Hamming top-2 kernel must beat
    knn = _device_timing(
        lambda dq, vq, dt_, vt: matching.knn_ratio_match(
            dq, vq, dt_, vt, ratio=cfg.matcher.ratio_frame),
        jax.device_put(margs, dev))
    L = cfg.map.proj_match_cap
    rng = np.random.default_rng(0)
    lm_desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    pargs = jax.device_put(
        (lm_desc, np.ones(L, bool),
         rng.uniform(0, [cam.width, cam.height], (L, 2)).astype(np.float32),
         np.asarray(f1.feat.xy), np.asarray(f1.feat.desc),
         np.asarray(f1.feat.valid), np.asarray(f1.feat.octave),
         np.ones(f1.feat.valid.shape, bool)), dev)
    proj = _device_timing(
        lambda *a: matching.projection_match(
            *a, radius=cfg.matcher.proj_radius,
            th_high=float(cfg.matcher.th_high),
            ratio=cfg.matcher.ratio_local), pargs)
    print(f"matcher device time: knn_ratio_match {len(dg)}x{dg.shape[1]} "
          f"{knn * 1e6:.1f} us/call; projection_match {L}x{dg.shape[1]} "
          f"{proj * 1e6:.1f} us/call (warm on-device loops)")
    return dict(kp_share=kp_share, pose_dt=dt, pose_dr=dr, lba_rel=rel,
                knn_us=knn * 1e6, proj_us=proj * 1e6)


# ---------------------------------------------------------------- VO / SLAM


def _ate(est_cw: np.ndarray, gt_cw: np.ndarray) -> float:
    from aslam import workloads
    from aslam.utils.trajectory import ate_rmse

    return ate_rmse(workloads.centers(est_cw), workloads.centers(gt_cw))


def phase_vo(cfg, n_chunks: int = 4, chunk: int = 64, label: str = "",
             ate_limit_m: float = ATE_LIMIT_M):
    """Phase 3: track_sequence over `n_chunks` chunks of `chunk` frames
    after a bootstrap frame.  Chunk 1 compiles; the rest are timed."""
    import jax
    import jax.numpy as jnp

    from aslam import workloads
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.models.odometry import track_sequence

    cam = cfg.camera
    n = 1 + n_chunks * chunk
    imgs, deps, poses = workloads.vo_sequence(cam, n)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    c0 = _compile_s[0]
    t0 = time.perf_counter()
    st = init_adaptive_state(cfg.extractor)
    prev, st = frame_mod.make_frame(jnp.asarray(imgs[0]),
                                    jnp.asarray(deps[0]), cfg, st)
    prev = frame_mod.with_pose(prev, jnp.eye(4))
    grid, Ts, t_steady = st.grid_thresholds, [], None
    for c in range(n_chunks):
        if c == 1:
            jax.block_until_ready(Ts)
            t_first = time.perf_counter() - t0
            t_steady = time.perf_counter()
        sl = slice(1 + c * chunk, 1 + (c + 1) * chunk)
        prev, grid, res = track_sequence(
            prev, jax.device_put(imgs[sl]), jax.device_put(deps[sl]), grid,
            keys[sl], cfg, cam.height, cam.width)
        Ts.append(res.T_cw)
    jax.block_until_ready(Ts)
    if t_steady is None:
        t_first, fps = time.perf_counter() - t0, float("nan")
    else:
        fps = (n_chunks - 1) * chunk / (time.perf_counter() - t_steady)
    est = np.concatenate([np.eye(4)[None], *map(np.asarray, Ts)])
    ate = _ate(est, poses)
    compile_s = _compile_s[0] - c0
    print(f"vo: {n} frames {cam.width}x{cam.height}, "
          f"{cfg.extractor.max_keypoints} keypoints, chunk {chunk}: compile "
          f"{compile_s:.1f} s, first chunk (with compile) {t_first:.1f} s, "
          f"steady {fps:.1f} frames/s [{label}]")
    print(f"vo: ATE {ate * 100:.3f} cm (limit {ate_limit_m * 100:.1f} cm)")
    check(np.isfinite(est).all() and ate <= ate_limit_m, "VO ATE")
    return dict(ate_m=ate, fps=fps, compile_s=compile_s)


def phase_slam(cfg, n_frames: int = 257, chunk: int = 64, label: str = "",
               ate_limit_m: float = ATE_LIMIT_M):
    """Phase 4: DeviceSlam over the walk, a bootstrap frame then chunks of
    `chunk` (one compiled scan length).  Pass 1 compiles, pass 2 is timed."""
    from aslam import workloads

    imgs, deps, poses = workloads.slam_walk(cfg.camera, n_frames)
    c0 = _compile_s[0]
    t0 = time.perf_counter()
    workloads.slam_pass(cfg, imgs, deps, chunk, seed=0)
    t_first = time.perf_counter() - t0
    compile_s = _compile_s[0] - c0
    t0 = time.perf_counter()
    dev = workloads.slam_pass(cfg, imgs, deps, chunk, seed=1)
    dt = time.perf_counter() - t0
    dev.finish()
    rebuilt = dev.rebuilt_trajectory()
    n_kfs = int(dev.state.n_kfs)
    n_loops = len(dev.loop_closing.loops) if dev.loop_closing else 0
    ate = _ate(rebuilt, poses)
    print(f"slam: {n_frames} frames, chunk {chunk}, K="
          f"{cfg.map.max_keyframes}, L={cfg.map.max_landmarks}: compile "
          f"{compile_s:.1f} s, pass 1 (with compile) {t_first:.1f} s, "
          f"pass 2 {dt:.2f} s = {n_frames / dt:.1f} frames/s [{label}]")
    print(f"slam: {n_kfs} keyframes, {n_loops} loops closed, rebuilt-"
          f"trajectory ATE {ate * 100:.3f} cm (limit "
          f"{ate_limit_m * 100:.1f} cm)")
    check(n_kfs > 1, "no keyframe mapped after the bootstrap keyframe")
    check(np.isfinite(rebuilt).all() and ate <= ate_limit_m, "SLAM ATE")
    return dict(ate_m=ate, fps=n_frames / dt, compile_s=compile_s,
                n_kfs=n_kfs)


def phase_cli(n_frames: int = 129, chunk: int = 64, camera: str = "fr3",
              ate_limit_m: float = ATE_LIMIT_M):
    """Phase 5: the CLI, in this process, on an on-disk TUM-layout
    sequence rendered at the `camera` preset (a preset without lens
    distortion, since the renderer draws none)."""
    from aslam import main as cli
    from aslam import workloads
    from aslam.utils.dataset import write_tum_sequence
    from aslam.utils.trajectory import ate_rmse, load_tum_trajectory

    cam = cli.CAMERAS[camera]
    check(not cam.has_distortion, f"camera {camera} has lens distortion")
    imgs, deps, poses = workloads.slam_walk(cam, n_frames, seed=21)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as d:
        seq, out = os.path.join(d, "seq"), os.path.join(d, "out")
        write_tum_sequence(seq, imgs, deps, poses)
        argv = ["--dataset", seq, "--camera", camera, "--engine", "device",
                "--mode", "slam+loop", "--chunk", str(chunk),
                "--out-dir", out]
        print("cli: python -m aslam.main " + " ".join(argv))
        c0 = _compile_s[0]
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
        t_est, p_est, _ = load_tum_trajectory(
            os.path.join(out, "CameraTrajectory.txt"))
        t_gt, p_gt, _ = load_tum_trajectory(
            os.path.join(seq, "groundtruth.txt"))
    check(len(t_est) == n_frames and np.allclose(t_est, t_gt),
          "CLI trajectory timestamps")
    ate = ate_rmse(p_est, p_gt)
    print(f"cli: {n_frames} frames in {wall:.1f} s wall (compile "
          f"{_compile_s[0] - c0:.1f} s), ATE {ate * 100:.3f} cm (limit "
          f"{ate_limit_m * 100:.1f} cm)")
    check(np.isfinite(p_est).all() and ate <= ate_limit_m, "CLI ATE")
    return dict(ate_m=ate)


# ---------------------------------------------------------------- 4 cards


def phase_four_cards(devices, n_kfs: int = 8192, n_feats: int = 256,
                     lba_cfg=None) -> dict:
    """Phase 6: (a) covisibility-partitioned sharded GN-CG on a mesh of
    `devices` vs global_ba.gn_cg_step on devices[0]; (b) sharded_local_ba
    at `lba_cfg`'s window vs lba.local_ba; (c) the session's post-loop
    GBA with post_gba_method="sharded_gn_cg"."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from aslam import workloads
    from aslam.config import (ExtractorConfig, LoopConfig, MapConfig,
                              SystemConfig)
    from aslam.models.loopclosing import LoopClosing
    from aslam.ops import global_ba, lba
    from aslam.parallel import mesh as mesh_mod
    from aslam.parallel import sharded_ba
    from aslam.parallel.partition import partitioned_gn_cg_step

    lba_cfg = lba_cfg or workloads.full_config()
    cam = workloads.TUM_FR1_PINHOLE
    cfg = SystemConfig(
        camera=cam, extractor=ExtractorConfig(max_keypoints=n_feats),
        map=MapConfig(max_keyframes=n_kfs,
                      max_landmarks=n_kfs * (n_feats // 4) + n_feats),
        loop=LoopConfig(post_gba_method="sharded_gn_cg"))
    m, _, _ = workloads.build_corridor_map(cfg, n_kfs, n_feats)
    m = jax.device_put(m, devices[0])
    n_dev = len(devices)
    chi2 = lambda mm: float(global_ba.map_chi2(mm, cam, cfg.ba))  # noqa: E731
    chi2_0 = chi2(m)
    out = {}

    # (a) GN-CG: one card vs the mesh
    t0 = time.perf_counter()
    ref, _ = global_ba.gn_cg_step(m, cam, cfg.ba,
                                  kf_chunk=min(256, n_kfs))
    jax.block_until_ready(ref)
    t_ref = time.perf_counter() - t0
    mesh = Mesh(np.array(devices).reshape(-1, 1), ("dp", "lm"))
    t0 = time.perf_counter()
    sh, _ = partitioned_gn_cg_step(m, cam, cfg.ba, mesh)
    jax.block_until_ready(sh)
    t_sh = time.perf_counter() - t0
    d_T = float(jnp.max(jnp.abs(jax.device_put(sh.kf_T_cw, devices[0])
                                - ref.kf_T_cw)))
    d_X = float(jnp.max(jnp.abs(jax.device_put(sh.lm_pos, devices[0])
                                - ref.lm_pos)))
    c_ref, c_sh = chi2(ref), chi2(jax.device_put(sh, devices[0]))
    print(f"four (a) GN-CG step, corridor map K={n_kfs} M={n_feats} "
          f"L={m.lm_pos.shape[0]}: chi2 {chi2_0:.6e} -> one card "
          f"{c_ref:.6e}, {n_dev}-card mesh {c_sh:.6e}; max|dT| {d_T:.2e}, "
          f"max|dX| {d_X:.2e} (limit 1e-3); first-call wall {t_ref:.1f} s "
          f"one card, {t_sh:.1f} s mesh (with compile)")
    check(c_sh < chi2_0 and d_T <= 1e-3 and d_X <= 1e-3,
          "sharded GN-CG vs one card")
    out.update(gn_cg_dT=d_T, gn_cg_dX=d_X, chi2_0=chi2_0, chi2_sh=c_sh)

    # (b) windowed-Schur local BA at the bench window
    prob, _, _ = lba_problem(lba_cfg)
    lmesh = mesh_mod.make_mesh(n_dev)
    p_ref, s_ref = lba.local_ba(jax.device_put(prob, devices[0]),
                                lba_cfg.camera, lba_cfg.ba)
    p_sh, chi2_sh, _ = sharded_ba.sharded_local_ba(
        sharded_ba.pad_problem(prob, lmesh), lba_cfg.camera, lba_cfg.ba,
        lmesh)
    C, Lw = prob.cam_T.shape[0], prob.points.shape[0]
    dT = float(np.max(np.abs(np.asarray(p_sh.cam_T)[:C]
                             - np.asarray(p_ref.cam_T))))
    dX = float(np.max(np.abs(np.asarray(p_sh.points)[:Lw]
                             - np.asarray(p_ref.points))))
    rel = abs(float(chi2_sh) - float(s_ref.chi2)) / max(float(s_ref.chi2),
                                                        1e-12)
    print(f"four (b) sharded_local_ba mesh {dict(lmesh.shape)} [C={C} "
          f"Lw={Lw}]: chi2 {float(chi2_sh):.6e} vs one card "
          f"{float(s_ref.chi2):.6e} (rel {rel:.2e}); max|dT| {dT:.2e}, "
          f"max|dX| {dX:.2e} (limit 1e-3)")
    check(dT <= 1e-3 and dX <= 1e-3 and rel <= 1e-3,
          "sharded local BA vs one card")

    # (c) the session path: LoopClosing meshes every device it has
    lc = LoopClosing(cfg.replace(
        loop=dataclasses.replace(cfg.loop, post_gba_method="sharded_gn_cg")))
    t0 = time.perf_counter()
    m2 = lc._post_loop_gba(m)
    jax.block_until_ready(m2)
    c_post = chi2(jax.device_put(m2, devices[0]))
    print(f"four (c) LoopClosing._post_loop_gba (sharded_gn_cg over "
          f"{len(jax.devices())} devices): chi2 {chi2_0:.6e} -> "
          f"{c_post:.6e} in {time.perf_counter() - t0:.1f} s (with compile)")
    check(c_post < chi2_0, "session sharded post-loop GBA reduces chi2")
    out.update(lba_dT=dT, lba_dX=dX, chi2_post=c_post)
    return out


# ---------------------------------------------------------------- main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    n_cards = 4 if args.four_cards else 1
    label = phase_device(n_cards)
    if args.four_cards:
        phase_four_cards(jax.devices())
    else:
        from aslam import workloads

        cfg = workloads.full_config()
        phase_parity(cfg, jax.devices()[0], jax.devices("cpu")[0])
        phase_vo(cfg, label=label)
        phase_slam(cfg, label=label)
        phase_cli()
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
