"""Per-stage profile of the full-SLAM device pipeline (VERDICT r4 task 1/2).

Methodology: chained-carry scan timing, each timed region ended by
`jax.block_until_ready`.  Each stage is wrapped in a `lax.scan` that
threads its state, so XLA cannot hoist the body; per-iteration time =
wall / n with the dispatch cost amortized n-fold.

Stages profiled at a realistic live map size (grown by the engine itself):
  track      slam_step, inline_mapping=False   (the per-frame hot path)
  full       slam_step, inline_mapping=True    (tracking + mapping branch)
  map_kf     map_keyframe_body                 (the whole per-KF refinement)
  desc       refresh_landmark_descriptors
  lm_cull    landmark_culling
  fuse       fuse_landmarks
  lm_pos     refresh_landmark_positions
  lba        build_window + build_problem + chain + local_ba + write_back
  kf_cull    keyframe_culling x3

Usage:  python scripts/profile_slam.py --kfs 512 --grow 300
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(label, fn, state, n, reps=2):
    """Compile, then time `n` chained applications of fn via lax.scan;
    returns (per_iter_ms, final_state)."""
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
    _ = float(jnp.sum(jnp.asarray(leaf, jnp.float32).ravel()[:16]))  # warm
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        out = run(state)
        leaf = jax.tree_util.tree_leaves(out)[0]
        _ = float(jnp.sum(jnp.asarray(leaf, jnp.float32).ravel()[:16]))
        best = min(best, (time.time() - t0) / n)
    print(f"  {label:10s} {best * 1e3:8.2f} ms/iter  ({n} chained)",
          flush=True)
    return best * 1e3, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=1024, help="capacity")
    ap.add_argument("--grow", type=int, default=300,
                    help="frames to run before profiling")
    ap.add_argument("--n", type=int, default=16, help="chained iterations")
    ap.add_argument("--save-state", default="",
                    help="npz path to save the grown map for reuse")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from aslam.config import (BAConfig, CameraModel, ExtractorConfig,
                                  MapConfig, SystemConfig)
    from aslam.models import mapstate as ms
    from aslam.models.device_slam import DeviceSlam, slam_step
    from aslam.models import localmapping as lm
    from aslam.ops import lba as lba_mod
    from aslam.utils import synthetic_hard as sh

    cam = CameraModel(fx=258.6, fy=258.2, cx=159.3, cy=127.6,
                      width=320, height=240)
    L = max(args.kfs * 64, 16384)
    cfg = SystemConfig(
        camera=cam,
        extractor=ExtractorConfig(n_features=512, max_keypoints=512),
        map=MapConfig(max_keyframes=args.kfs, max_landmarks=L),
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192),
        use_loop_closing=False,
    )
    print("devices:", jax.devices(), flush=True)
    print(f"capacity K={args.kfs} L={L}", flush=True)

    # ---- grow a live map with the engine itself
    rng = np.random.default_rng(3)
    scene = sh.room_scene(rng, half_x=2.2, half_y=1.4, half_z=2.8)
    from scripts.scale_slam_bench import bounded_walk
    poses = bounded_walk(args.grow, rng)
    print(f"rendering {args.grow} frames...", flush=True)
    imgs, deps = [], []
    for i in range(args.grow):
        img, dep, _ = sh.render(cam, poses[i], scene, rng=rng)
        imgs.append(img)
        deps.append(dep)
    imgs, deps = np.stack(imgs), np.stack(deps)

    dev = DeviceSlam(cfg, seed=0, sync_every=10**9, inline_mapping=True)
    t0 = time.time()
    for c0 in range(0, args.grow, 64):
        dev.process_chunk(imgs[c0:c0 + 64], deps[c0:c0 + 64])
    n_kfs = int(dev.state.n_kfs)   # completion read
    t_grow = time.time() - t0
    print(f"grew map: {n_kfs} live KFs in {t_grow:.1f}s "
          f"({args.grow / t_grow:.1f} fps incl. compile)", flush=True)

    st = dev.state
    key = jax.random.PRNGKey(7)
    h, w = cam.height, cam.width
    img_j = jnp.asarray(imgs[-1])
    dep_j = jnp.asarray(deps[-1])

    # a live KF slot to refine (the newest)
    slots = np.asarray(st.m.kf_valid)
    ids = np.asarray(st.m.kf_id)
    live = np.nonzero(slots)[0]
    newest = live[np.argmax(ids[live])]
    print(f"profiling at K={n_kfs}, newest slot={newest}", flush=True)

    n = args.n
    print("\n--- per-stage device time (chained-carry, completion reads) ---",
          flush=True)

    # tracking-only step
    def track_only(s):
        s2, *_ = slam_step(s, img_j, dep_j, key, cfg, h, w,
                           inline_mapping=False)
        return s2
    timed("track", track_only, st, n)

    # full step (mapping branch taken iff KF trigger fires; to measure the
    # branch cost force need_kf by measuring map_keyframe_body directly)
    def full_step(s):
        s2, *_ = slam_step(s, img_j, dep_j, key, cfg, h, w,
                           inline_mapping=True)
        return s2
    timed("full", full_step, st, n)

    m0 = st.m
    slot_j = jnp.int32(int(newest))
    kfid_j = jnp.int32(int(ids[newest]))

    def map_kf(m):
        m2, _ = lm.map_keyframe_body(m, slot_j, kfid_j, cfg)
        return m2
    timed("map_kf", map_kf, m0, n)

    Lb = m0.lm_pos.shape[0]

    def desc(m):
        row = m.kf_lm[slot_j]
        return ms.refresh_landmark_descriptors_ids(
            m, jnp.maximum(row, 0), (row >= 0) & m.kf_kp_valid[slot_j])
    timed("desc", desc, m0, n)

    def lm_cull(m):
        return ms.landmark_culling(m, kfid_j, cfg)
    timed("lm_cull", lm_cull, m0, n)

    def fuse(m):
        return lm.fuse_landmarks(m, slot_j, cfg)
    timed("fuse", fuse, m0, n)

    if cfg.map.refresh_positions:
        def lm_pos(m):
            return ms.refresh_landmark_positions(m, cfg)
        timed("lm_pos", lm_pos, m0, n)

    def lba_stage(m):
        spec = lm.build_window(m, slot_j, cfg)
        prob, lw_ids, _ = lm.build_problem(m, spec, cfg)
        chain = (lm.build_chain(m, spec, cfg)
                 if cfg.ba.chain_prior_weight > 0 else None)
        prob, _ = lba_mod.local_ba(prob, cfg.camera, cfg.ba, chain=chain,
                                   group=m.kf_lm.shape[1])
        return lm.write_back(m, spec, prob, lw_ids, cfg)
    timed("lba", lba_stage, m0, n)

    # LBA decomposition
    def lba_build(m):
        spec = lm.build_window(m, slot_j, cfg)
        prob, lw_ids, _ = lm.build_problem(m, spec, cfg)
        return lm.write_back(m, spec, prob, lw_ids, cfg)
    timed("lba_build", lba_build, m0, n)

    def kf_cull(m):
        for _ in range(3):
            m, _ = ms.keyframe_culling(m, slot_j, cfg)
        return m
    timed("kf_cull", kf_cull, m0, n)

    if args.save_state:
        from aslam.utils.checkpoint import save_map
        save_map(args.save_state, st.m)
        print(f"saved map to {args.save_state}")


if __name__ == "__main__":
    main()
