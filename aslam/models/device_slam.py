"""Device-resident SLAM: the whole pipeline — feature extraction,
odometry, local-map tracking, keyframe decision AND insertion, local
mapping, loop cadence — with zero per-frame host round-trips.

Motivation: a device->host read stalls the dispatch queue until the
device drains, so any per-frame scalar pull serializes host and device
work.  The reference faces the same structural problem with its pthread
handoffs and solves it with a background mapping thread (main.cpp:85);
the device equivalent is:

  * tracking hot path: `slam_step` — fully on device, keyframe insertion
    under `lax.cond` (the branch executes only when taken), pose appended
    to a device-side ring buffer; inserted keyframes are recorded in an
    on-device ring so the host never reads ids at frame rate;
  * "LocalMapping thread": at a low sync cadence the host reads the
    insertion ring ONCE, then dispatches the fused per-keyframe mapping
    program (localmapping.map_keyframe_fused: descriptor refresh, cull,
    fuse, windowed LBA, KF culling — one program, no scalar reads);
    culled-KF parent-chain records stay on device until finish();
  * "LoopClosing thread": the same sync batches loop DETECTION for the
    window's fresh keyframes into one stacked read
    (loopclosing.process_keyframes_batch); the expensive
    verify/correct path only runs on actual candidate hits.

The host Tracking class (models/tracking.py) remains the step-by-step
reference implementation; this module is the production path.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import SystemConfig
from aslam.models import frame as frame_mod
from aslam.models import mapstate as ms
from aslam.models.extractor import init_adaptive_state
from aslam.models.odometry import rba_step
from aslam.models.tracking import carry_associations, track_local_map
from aslam.utils.se3 import T_inv, pose_distance


class SlamState(NamedTuple):
    m: ms.MapState
    last_frame: frame_mod.FrameData
    last_assoc: jnp.ndarray     # [M]
    last_kf_T: jnp.ndarray      # [4,4]
    grid_thresholds: jnp.ndarray
    n_kfs: jnp.ndarray          # scalar int32
    next_lm: jnp.ndarray        # scalar int32
    kf_counter: jnp.ndarray     # scalar int32
    # insertion ring: slots/ids of keyframes inserted since the last host
    # sync (drained by DeviceSlam._background_mapping with ONE read)
    recent_slots: jnp.ndarray   # [R] int32
    recent_ids: jnp.ndarray     # [R] int32
    recent_n: jnp.ndarray       # scalar int32 (raw count; > R = overflow)


def init_slam(cfg: SystemConfig, img: np.ndarray, depth: np.ndarray,
              ring: int = 128) -> SlamState:
    """Bootstrap: first frame becomes KF 0 with landmarks from every
    valid-depth keypoint (tracking.cpp:80-121)."""
    ad = init_adaptive_state(cfg.extractor)
    frame, ad = frame_mod.make_frame(
        jnp.asarray(img), jnp.asarray(depth), cfg, ad)
    frame = frame_mod.with_pose(frame, jnp.eye(4))
    M = cfg.extractor.max_keypoints
    m = ms.init_map(cfg)
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, frame, assoc, jnp.int32(0), jnp.int32(0))
    m, assoc, n_created = ms.create_landmarks(
        m, frame, assoc, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth),
    )
    recent_slots = jnp.full((ring,), -1, jnp.int32).at[0].set(0)
    recent_ids = jnp.full((ring,), -1, jnp.int32).at[0].set(0)
    return SlamState(
        m=m, last_frame=frame, last_assoc=assoc,
        last_kf_T=frame.T_cw, grid_thresholds=ad.grid_thresholds,
        n_kfs=jnp.int32(1), next_lm=n_created.astype(jnp.int32),
        kf_counter=jnp.int32(1),
        recent_slots=recent_slots, recent_ids=recent_ids,
        recent_n=jnp.int32(1),
    )


@functools.partial(jax.jit, static_argnames=(
    "cfg", "height", "width", "inline_mapping"))
def slam_step(
    state: SlamState,
    img: jnp.ndarray,
    depth: jnp.ndarray,
    key: jnp.ndarray,
    cfg: SystemConfig,
    height: int,
    width: int,
    inline_mapping: bool = True,
):
    """One frame, fully on device.  Returns (state', T_cw, stats[9],
    ref_id, T_cr, cull): stats = [n_tracked, n_matches, ransac_inliers,
    kf_dist, kf_rot, rmse, inserted_kf, n_kfs, proj_overflow]; (ref_id,
    T_cr) is this frame's pose RELATIVE to its reference keyframe (the
    reference's mlRelativeFramePoses records, tracking.cpp:407-413),
    enabling the corrected-trajectory rebuild at export time; cull is a
    CullInfo[3] of this frame's keyframe-culling events.

    With `inline_mapping` the ENTIRE local-mapping refinement
    (localmapping.map_keyframe_body: descriptor refresh, landmark cull,
    fuse, windowed LBA, KF cull) runs inside the keyframe-insertion
    branch — the reference's background mapping thread
    (localmapping.cpp:28-52) collapses into the tracking program, paying
    its cost only on keyframe frames and NEVER crossing the host link.
    """
    frame, new_grid = frame_mod._make_frame_impl(
        img, depth, state.grid_thresholds, cfg, height, width)

    if cfg.use_gicp:
        # ADAPTIVE_RICP: GICP escalation under lax.cond, still one program
        from aslam.models.odometry import ricp_fused

        odo = ricp_fused(state.last_frame, frame, key, cfg)
    else:
        odo = rba_step(state.last_frame, frame, key, cfg)
    frame = frame_mod.with_pose(frame, odo.T_cw2)
    assoc = carry_associations(state.last_assoc, odo.match_idx, odo.inliers)
    # odometry/map fusion gate (mirrors tracking.track_step): the stiff
    # motion prior only anchors the local-map pose solve when odometry
    # itself was healthy — a failed RANSAC must not pin the frame to a
    # bad/stale pose that map evidence could otherwise correct.
    odo_ok = odo.n_inliers >= cfg.ransac.min_inliers
    w_prior = jnp.where(odo_ok, cfg.tracking.pose_prior_weight, 0.0)
    lm_res = track_local_map(state.m, frame, assoc, cfg,
                             prior_weight=w_prior)
    frame = frame_mod.with_pose(frame, lm_res.T_cw)
    assoc = lm_res.assoc
    m = state.m._replace(
        lm_visible=state.m.lm_visible
        + lm_res.visible_mask.astype(jnp.int32),
        lm_found=state.m.lm_found + lm_res.found_mask.astype(jnp.int32),
    )

    dt, dr = pose_distance(state.last_kf_T, frame.T_cw)
    # capacity = any free slot (culling frees rows for reuse)
    need_kf = (
        ((dt > cfg.tracking.kf_min_trans) | (dr > cfg.tracking.kf_min_rot))
        & ~jnp.all(m.kf_valid)
    )

    R = state.recent_slots.shape[0]
    from aslam.models.localmapping import (empty_cull_info,
                                               map_keyframe_body)

    def insert(args):
        m, assoc = args
        slot = jnp.argmin(m.kf_valid).astype(jnp.int32)  # first free row
        kf_id = state.kf_counter
        m = ms.insert_keyframe(m, frame, assoc, slot, kf_id)
        m, assoc, n_created = ms.create_landmarks(
            m, frame, assoc, slot, kf_id,
            max_new=cfg.tracking.max_vo_points,
            th_depth=float(cfg.camera.th_depth),
        )
        if inline_mapping:
            # the "LocalMapping thread", inline: refine the new keyframe
            # right here (the reference maps each KF immediately after
            # insertion); cost is paid only when this branch is taken
            m, cull = map_keyframe_body(m, slot, kf_id, cfg)
        else:
            cull = empty_cull_info()
        # mapping may have refined the new KF's pose: the reference KF
        # pose used by the keyframe trigger must be the refined one
        new_ref_T = m.kf_T_cw[slot]
        idx = jnp.minimum(state.recent_n, R - 1)
        rs = state.recent_slots.at[idx].set(slot)
        ri = state.recent_ids.at[idx].set(kf_id)
        return m, assoc, state.n_kfs + 1, state.next_lm + n_created, \
            state.kf_counter + 1, new_ref_T, rs, ri, state.recent_n + 1, \
            cull

    def skip(args):
        m, assoc = args
        return m, assoc, state.n_kfs, state.next_lm, state.kf_counter, \
            state.last_kf_T, state.recent_slots, state.recent_ids, \
            state.recent_n, empty_cull_info()

    (m, assoc, n_kfs, next_lm, kf_counter, last_kf_T,
     recent_slots, recent_ids, recent_n, cull) = jax.lax.cond(
        need_kf, insert, skip, (m, assoc))
    # inline mapping can cull keyframes — count live rows, don't increment
    n_kfs = jnp.sum(m.kf_valid.astype(jnp.int32))

    new_state = SlamState(
        m=m, last_frame=frame, last_assoc=assoc, last_kf_T=last_kf_T,
        grid_thresholds=new_grid, n_kfs=n_kfs, next_lm=next_lm,
        kf_counter=kf_counter,
        recent_slots=recent_slots, recent_ids=recent_ids,
        recent_n=recent_n,
    )
    stats = jnp.stack([
        lm_res.n_tracked.astype(jnp.float32),
        odo.n_matches.astype(jnp.float32),
        odo.n_inliers.astype(jnp.float32),
        dt, dr, odo.rmse,
        need_kf.astype(jnp.float32),
        n_kfs.astype(jnp.float32),
        lm_res.n_overflow.astype(jnp.float32),
    ])
    ref_id = kf_counter - 1
    T_cr = frame.T_cw @ T_inv(last_kf_T)
    return new_state, frame.T_cw, stats, ref_id, T_cr, cull


@functools.partial(jax.jit, static_argnames=(
    "cfg", "height", "width", "inline_mapping"))
def slam_scan(
    state: SlamState,
    key: jnp.ndarray,
    imgs: jnp.ndarray,    # [T,H,W]
    depths: jnp.ndarray,  # [T,H,W]
    cfg: SystemConfig,
    height: int,
    width: int,
    inline_mapping: bool = True,
):
    """Chained multi-frame SLAM: `lax.scan` of `slam_step` over a frame
    chunk — ONE device program per chunk instead of one per frame.

    The PRNG key is carried through the scan with the same
    `split(key) -> (key, sub)` recurrence the streaming wrapper uses, so a
    chunked run matches the frame-by-frame path given the same starting
    key (test-enforced; agreement is exact up to cross-program
    floating-point reassociation — see test_batch_vo for the mechanism).  Dispatch latency, not device compute,
    bounds the streaming rate (docs/PERF.md), so chunking amortizes it
    chunk-length-fold for recorded-sequence / serving workloads.

    Returns (state', key', T_cw [T,4,4], stats [T,9], ref_ids [T],
    T_cr [T,4,4], cull CullInfo[T,3]).
    """

    def step(carry, xs):
        st, k = carry
        img, depth = xs
        k, sub = jax.random.split(k)
        st, T, stats, ref_id, T_cr, cull = slam_step(
            st, img, depth, sub, cfg, height, width,
            inline_mapping=inline_mapping)
        return (st, k), (T, stats, ref_id, T_cr, cull)

    (state, key), (Ts, stats, ref_ids, T_crs, culls) = jax.lax.scan(
        step, (state, key), (imgs, depths))
    return state, key, Ts, stats, ref_ids, T_crs, culls


@jax.jit
def _drain_ring(state: SlamState) -> SlamState:
    """Reset the insertion ring (after the host has read it)."""
    return state._replace(
        recent_slots=jnp.full_like(state.recent_slots, -1),
        recent_ids=jnp.full_like(state.recent_ids, -1),
        recent_n=jnp.int32(0),
    )


@jax.jit
def _pack_ring(state: SlamState) -> jnp.ndarray:
    """[2R+2] int32: slots ++ ids ++ [count, n_kfs] — ONE host read."""
    return jnp.concatenate([
        state.recent_slots, state.recent_ids,
        state.recent_n[None], state.n_kfs[None],
    ])


class DeviceSlam:
    """Host wrapper: streams frames into `slam_step` (or chunks into
    `slam_scan`).  With `inline_mapping` (default) the whole local-mapping
    refinement runs INSIDE the per-frame program, so the steady-state loop
    performs zero host reads; the sync cadence only serves the loop-closing
    detector (one packed-ring read + one stacked candidate read per sync,
    nothing at all when loop closing is off)."""

    def __init__(self, cfg: SystemConfig, seed: int = 0, sync_every: int = 8,
                 ring: int = 128, inline_mapping: bool = True):
        self.cfg = cfg
        self.key = jax.random.PRNGKey(seed)
        self.sync_every = sync_every
        self.ring = ring
        self.inline_mapping = inline_mapping
        self.state: SlamState | None = None
        self.pose_buf: list = []
        self.stats_buf: list = []
        self.ref_id_buf: list = []
        self.rel_pose_buf: list = []
        self.timestamps: list[float] = []
        self.n_processed = 0
        self.last_mapped_id = 0      # kf_id high-water mark through mapping
        self.last_n_kfs = 1          # live KF count as of the last sync read
        self._cull_pending: list = []   # unread CullInfo device pytrees
        from aslam.models.localmapping import map_keyframe_fused

        self._map_kf = map_keyframe_fused
        self.loop_closing = None
        if cfg.use_loop_closing:
            from aslam.models.loopclosing import LoopClosing

            self.loop_closing = LoopClosing(cfg)

    def process(self, img: np.ndarray, depth: np.ndarray, t: float = 0.0):
        if self.state is None:
            self._bootstrap(img, depth, t)
            return
        self.key, sub = jax.random.split(self.key)
        h, w = img.shape
        self.state, T, stats, ref_id, T_cr, cull = slam_step(
            self.state, jnp.asarray(img), jnp.asarray(depth), sub,
            self.cfg, h, w, inline_mapping=self.inline_mapping)
        # buffers hold [T, ...] arrays (chunk granularity): export-time
        # concatenation is a handful of operands, not one per frame
        self.pose_buf.append(T[None])
        self.stats_buf.append(stats[None])
        self.ref_id_buf.append(ref_id[None])
        self.rel_pose_buf.append(T_cr[None])
        if self.inline_mapping:
            self._cull_pending.append(cull)
        self.timestamps.append(t)
        self.n_processed += 1
        if self.n_processed % self.sync_every == 0:
            self._background_mapping()

    def _bootstrap(self, img, depth, t):
        self.state = init_slam(self.cfg, img, depth, ring=self.ring)
        self.pose_buf.append(self.state.last_frame.T_cw[None])
        # no stats row for the bootstrap frame (tracking ran on frames
        # 1..N-1 only — stats length stays N-1, as in streaming mode)
        self.ref_id_buf.append(jnp.zeros((1,), jnp.int32))
        self.rel_pose_buf.append(jnp.eye(4)[None])
        self.timestamps.append(t)
        self.n_processed += 1

    def process_chunk(self, imgs: np.ndarray, depths: np.ndarray,
                      ts=None):
        """Feed a chunk of frames through `slam_scan` (one dispatch).
        Bit-identical to calling `process` per frame, minus the
        per-frame mapping-cadence checks (mapping runs once per chunk)."""
        n = len(imgs)
        if ts is None:
            ts = [0.0] * n
        start = 0
        if self.state is None:
            self._bootstrap(np.asarray(imgs[0]), np.asarray(depths[0]),
                            ts[0])
            start = 1
        if start >= n:
            return
        h, w = np.asarray(imgs[0]).shape
        self.state, self.key, Ts, stats, ref_ids, T_crs, culls = slam_scan(
            self.state, self.key, jnp.asarray(imgs[start:]),
            jnp.asarray(depths[start:]), self.cfg, h, w,
            inline_mapping=self.inline_mapping)
        self.pose_buf.append(Ts)
        self.stats_buf.append(stats)
        self.ref_id_buf.append(ref_ids)
        self.rel_pose_buf.append(T_crs)
        if self.inline_mapping:
            self._cull_pending.append(culls)   # CullInfo [T,3,...]
        self.timestamps.extend(ts[start:])
        before = self.n_processed
        self.n_processed += n - start
        # same cadence as streaming: map when a sync boundary was crossed
        # (at chunk end rather than mid-chunk)
        if self.n_processed // self.sync_every != before // self.sync_every:
            self._background_mapping()

    def _background_mapping(self):
        """The sync cadence.  Inline mode: mapping already happened inside
        the per-frame program — this only serves loop closing (skip
        entirely, zero reads, when loop closing is off).  Non-inline mode:
        drain the insertion ring with ONE host read and dispatch the fused
        mapping program per fresh keyframe (cull records stay on device
        until finish()), then run batched loop detection."""
        if self.state is None:
            return
        if self.inline_mapping and self.loop_closing is None:
            return                      # nothing to do, nothing to read
        packed = np.asarray(_pack_ring(self.state))   # the one read
        R = self.ring
        slots, ids = packed[:R], packed[R:2 * R]
        count = int(packed[2 * R])
        self.last_n_kfs = int(packed[2 * R + 1])
        if count > R:
            raise RuntimeError(
                f"insertion ring overflow ({count} > {R}): raise `ring` "
                f"or lower `sync_every`/chunk length")
        self.state = _drain_ring(self.state)
        live = (slots >= 0) & (ids > self.last_mapped_id)
        fresh = np.argsort(ids[live])
        f_slots = slots[live][fresh]
        f_ids = ids[live][fresh]
        m = self.state.m
        if not self.inline_mapping:
            for slot, kf_id in zip(f_slots, f_ids):
                m, cull = self._map_kf(m, jnp.int32(int(slot)),
                                       jnp.int32(int(kf_id)), self.cfg)
                self._cull_pending.append(cull)
        if len(f_ids):
            self.last_mapped_id = max(self.last_mapped_id, int(f_ids[-1]))
        if self.loop_closing is not None and len(f_slots):
            m = self.loop_closing.process_keyframes_batch(
                m, f_slots.tolist(), f_ids.tolist(),
                n_live=self.last_n_kfs)
        if len(f_slots):
            # mapping/loop moved keyframes: re-anchor the tracker's
            # reference-KF pose to the refined map (the reference reads
            # mpReferenceKF->GetPose() fresh per frame)
            new_ref = m.kf_T_cw[jnp.int32(int(f_slots[-1]))]
            self.state = self.state._replace(m=m, last_kf_T=new_ref)
        else:
            self.state = self.state._replace(m=m)

    @property
    def kfs_mapped(self) -> int:
        """Keyframes through the mapping refinement.  Inline mode: every
        inserted KF is mapped at insertion; the counter read is one
        scalar (export-time use only)."""
        if self.inline_mapping:
            return int(self.state.n_kfs) if self.state is not None else 0
        return self.last_mapped_id + 1

    def culled_registry(self) -> dict:
        """kf_id -> (parent_kf_id, T_cp) for every culled keyframe
        (reads the pending device records; used at export time)."""
        culled: dict[int, tuple[int, np.ndarray]] = {}
        for rec in self._cull_pending:
            # leaves are [3] (per-dispatch records) or [T,3] (scan chunks)
            did = np.asarray(rec.culled).reshape(-1)
            kid = np.asarray(rec.kf_id).reshape(-1)
            pid = np.asarray(rec.parent_kf_id).reshape(-1)
            tcp = np.asarray(rec.T_cp).reshape(-1, 4, 4)
            for j in np.nonzero(did)[0]:
                culled[int(kid[j])] = (int(pid[j]), tcp[j])
        return culled

    def finish(self):
        """Flush mapping and pull the trajectory (one batched read)."""
        self._background_mapping()
        traj = np.asarray(jnp.concatenate(self.pose_buf))
        stats = (np.asarray(jnp.concatenate(self.stats_buf))
                 if self.stats_buf else np.zeros((0, 9)))
        return traj, stats

    def rebuilt_trajectory(self) -> np.ndarray:
        """Camera trajectory rebuilt from the FINAL keyframe poses:
        T_cw(t) = T_cr(t) @ T_rw(final), walking the culled-KF parent
        chain to a surviving ancestor (SaveTrajectory semantics,
        tracking.cpp:544-582) — local BA, culling, and loop corrections
        propagate retroactively.  Call after finish()."""
        m = self.state.m
        kf_valid = np.asarray(m.kf_valid)
        kf_ids = np.asarray(m.kf_id)
        kf_T = np.asarray(m.kf_T_cw)
        id2slot = {int(i): s for s, i in enumerate(kf_ids) if kf_valid[s]}
        culled = self.culled_registry()
        refs = np.asarray(jnp.concatenate(self.ref_id_buf))
        rels = np.asarray(jnp.concatenate(self.rel_pose_buf))
        frozen = np.asarray(jnp.concatenate(self.pose_buf))
        out = []
        for i in range(len(refs)):
            T_acc = rels[i]
            r = int(refs[i])
            hops = 0
            while r not in id2slot and r in culled and hops < len(culled) + 1:
                parent, T_rp = culled[r]
                T_acc = T_acc @ T_rp
                r = parent
                hops += 1
            if r in id2slot:
                out.append(T_acc @ kf_T[id2slot[r]])
            else:  # no surviving ancestor: keep the frozen track-time pose
                out.append(frozen[i])
        return np.stack(out)

    def save(self, prefix: str) -> None:
        """Checkpoint the FULL session mid-run: device state (map +
        tracker carry), host-side trajectory buffers, culled-KF registry,
        and the loop-closing vocabulary/database — enough for `resume` in
        a fresh process to continue the session and still export the
        complete corrected trajectory (SURVEY §5: the reference has no
        persistence at all; config-5 runs need it)."""
        self._background_mapping()
        st = self.state
        leaves = jax.tree_util.tree_leaves(st)
        culled = self.culled_registry() if self.inline_mapping else {}
        np.savez_compressed(
            prefix + ".session.npz",
            n_leaves=np.int64(len(leaves)),
            **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
            poses=np.asarray(jnp.concatenate(self.pose_buf)),
            stats=(np.asarray(jnp.concatenate(self.stats_buf))
                   if self.stats_buf else np.zeros((0, 9), np.float32)),
            ref_ids=np.asarray(jnp.concatenate(self.ref_id_buf)),
            rels=np.asarray(jnp.concatenate(self.rel_pose_buf)),
            ts=np.asarray(self.timestamps),
            n_processed=np.int64(self.n_processed),
            last_mapped_id=np.int64(self.last_mapped_id),
            last_n_kfs=np.int64(self.last_n_kfs),
            culled_ids=np.asarray(list(culled.keys()), np.int64),
            culled_parents=np.asarray(
                [v[0] for v in culled.values()], np.int64),
            culled_T=(np.stack([v[1] for v in culled.values()])
                      if culled else np.zeros((0, 4, 4), np.float32)),
        )
        if self.loop_closing is not None and self.loop_closing.vocab is not None:
            from aslam.ops import bow

            bow.save_vocabulary(prefix + ".vocab.npz",
                                self.loop_closing.vocab)
            db = self.loop_closing.db
            np.savez_compressed(
                prefix + ".loopdb.npz",
                **{f: np.asarray(getattr(db, f)) for f in db._fields},
                _n_loops=np.int64(len(self.loop_closing.loops)),
                _last_loop_kf_id=np.int64(
                    getattr(self.loop_closing, "last_loop_kf_id", -1) or -1),
            )

    @classmethod
    def resume(cls, prefix: str, cfg: SystemConfig, **kwargs) -> "DeviceSlam":
        """Rebuild a session from `save` output (fresh process OK)."""
        dev = cls(cfg, **kwargs)
        data = np.load(prefix + ".session.npz")
        # template state defines the pytree structure; its leaves are
        # replaced wholesale by the checkpointed ones
        h, w = cfg.camera.height, cfg.camera.width
        template = init_slam(
            cfg, np.zeros((h, w), np.float32),
            np.zeros((h, w), np.float32), ring=dev.ring)
        treedef = jax.tree_util.tree_structure(template)
        n = int(data["n_leaves"])
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
        dev.state = jax.tree_util.tree_unflatten(treedef, leaves)
        dev.pose_buf = [jnp.asarray(data["poses"])]
        if len(data["stats"]):
            dev.stats_buf = [jnp.asarray(data["stats"])]
        dev.ref_id_buf = [jnp.asarray(data["ref_ids"])]
        dev.rel_pose_buf = [jnp.asarray(data["rels"])]
        dev.timestamps = list(np.asarray(data["ts"]))
        dev.n_processed = int(data["n_processed"])
        dev.last_mapped_id = int(data["last_mapped_id"])
        dev.last_n_kfs = int(data["last_n_kfs"])
        # culled-KF registry re-enters as one pre-read record
        ids = data["culled_ids"]
        if len(ids):
            from aslam.models.mapstate import CullInfo

            dev._cull_pending = [CullInfo(
                culled=jnp.ones(len(ids), bool),
                kf_id=jnp.asarray(ids, jnp.int32),
                parent_kf_id=jnp.asarray(data["culled_parents"], jnp.int32),
                T_cp=jnp.asarray(data["culled_T"]),
            )]
        if dev.loop_closing is not None and os.path.exists(
                prefix + ".vocab.npz"):
            from aslam.ops import bow

            dev.loop_closing.vocab = bow.load_vocabulary(prefix + ".vocab.npz")
            db_data = np.load(prefix + ".loopdb.npz")
            db_cls = type(dev.loop_closing.db)
            dev.loop_closing.db = db_cls(**{
                f: jnp.asarray(db_data[f]) for f in db_cls._fields})
            dev.loop_closing.last_loop_kf_id = int(
                db_data["_last_loop_kf_id"])
        return dev

    def new_sequence(self, img: np.ndarray, depth: np.ndarray,
                     t: float = 0.0) -> bool:
        """Start a new input sequence into the SAME map (multi-sequence
        mapping): relocalize the first frame against the map (loop
        closing's BoW database when available), else continue from the
        last reference-KF pose, then bootstrap landmark bindings with a
        wide projection search.  Returns True when the frame re-anchored
        with enough bindings."""
        from aslam.models.tracking import bootstrap_track

        self._background_mapping()   # flush before touching the map
        st = self.state
        ad_holder = init_adaptive_state(self.cfg.extractor)._replace(
            grid_thresholds=st.grid_thresholds)
        frame, ad = frame_mod.make_frame(
            jnp.asarray(img), jnp.asarray(depth), self.cfg, ad_holder)
        T0 = None
        if self.loop_closing is not None:
            T0 = self.loop_closing.relocalize(st.m, frame)
        if T0 is None:
            T0 = np.asarray(st.last_kf_T)
        frame = frame_mod.with_pose(frame, jnp.asarray(T0))
        T_b, assoc, n_b = bootstrap_track(st.m, frame, self.cfg)
        ok = int(n_b) >= 10
        if ok:
            frame = frame_mod.with_pose(frame, T_b)
        self.state = st._replace(
            last_frame=frame, last_assoc=assoc,
            grid_thresholds=ad.grid_thresholds,
        )
        self.pose_buf.append(frame.T_cw[None])
        self.stats_buf.append(jnp.zeros((1, 9)))
        self.ref_id_buf.append((st.kf_counter - 1)[None])
        self.rel_pose_buf.append((frame.T_cw @ T_inv(st.last_kf_T))[None])
        self.timestamps.append(t)
        self.n_processed += 1
        return ok
