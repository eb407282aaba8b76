"""Tracking front-end: per-frame pose estimation against the map.

Replaces `System/tracking.{h,cpp}` (SURVEY.md component 2).  State machine
NO_IMAGES_YET -> NOT_INITIALIZED -> OK (tracking.h:32-38) lives on the host;
each stage is one jitted computation:

  TrackFrame     = rba_step (knn match -> RANSAC -> motion-BA) +
                   landmark-association carry-over (tracking.cpp:193-229)
  TrackLocalMap  = covisibility-voted local keyframes (cap 80,
                   tracking.cpp:263-346) -> frustum + projection match
                   (tracking.cpp:368-405) -> pose-only BA -> association
                   pruning (tracking.cpp:231-261)
  NeedNewKeyFrame= ||t|| > 0.15 m or rot > 0.25 rad vs the reference KF
                   (tracking.cpp:449-476)

The keyframe decision reads three scalars from device; everything else
stays resident.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import SystemConfig
from aslam.models import frame as frame_mod
from aslam.models import mapstate as ms
from aslam.models.extractor import init_adaptive_state
from aslam.models.odometry import rba_step
from aslam.ops import ba, matching
from aslam.utils import camera
from aslam.utils.se3 import pose_distance


@jax.jit
def carry_associations(
    last_assoc: jnp.ndarray,   # [M] landmark ids bound to last frame
    match_idx: jnp.ndarray,    # [M] last-frame feature -> current feature
    inliers: jnp.ndarray,      # [M] RANSAC inlier mask over last features
) -> jnp.ndarray:
    """Propagate landmark bindings through frame-to-frame matches
    (the reference carries Landmark* pointers inside KnnMatch,
    matcher.cpp:23-88)."""
    M = last_assoc.shape[0]
    ok = (match_idx >= 0) & inliers & (last_assoc >= 0)
    tgt = jnp.where(ok, match_idx, M)
    return jnp.full((M + 1,), -1, jnp.int32).at[tgt].max(
        jnp.where(ok, last_assoc, -1)
    )[:M]


class LocalMapResult(NamedTuple):
    T_cw: jnp.ndarray        # refined pose
    assoc: jnp.ndarray       # [M] final landmark bindings (outliers dropped)
    n_tracked: jnp.ndarray   # scalar int32 inlier landmark count
    visible_mask: jnp.ndarray  # [L] frustum-visible landmarks
    found_mask: jnp.ndarray    # [L] tracked-inlier landmarks
    local_kf_mask: jnp.ndarray # [K]
    n_overflow: jnp.ndarray    # scalar int32: frustum-visible candidates
                               # dropped by the proj_match_cap compaction


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_local_map(
    m: ms.MapState,
    frame: frame_mod.FrameData,
    assoc: jnp.ndarray,
    cfg: SystemConfig,
    prior_weight: jnp.ndarray | float | None = None,
) -> LocalMapResult:
    cam = cfg.camera
    K = m.kf_valid.shape[0]
    L = m.lm_pos.shape[0]
    M = assoc.shape[0]

    # 1. covisibility vote: KFs sharing landmarks with the current frame
    #    (tracking.cpp:263-307), local map capped at local_map_max_kfs.
    #    The frame's bound landmarks walk the observer reverse index —
    #    O(M * max_obs_per_lm), no [K,M]-wide gather (docs/PERF.md r5).
    a_ok = assoc >= 0
    a_ids = jnp.maximum(assoc, 0)
    a_ok = a_ok & m.lm_valid[a_ids]
    votes = ms.kf_votes_of_ids(m, a_ids, a_ok).astype(jnp.float32)
    kf_rank = jnp.where(m.kf_valid & (votes > 0), votes, -1.0)
    k_cap = min(cfg.tracking.local_map_max_kfs, K)
    top_vals, top_idx = jax.lax.top_k(kf_rank, k_cap)
    local_kf = jnp.zeros((K,), bool).at[top_idx].set(top_vals > 0)

    # 1b. one-hop covisibility expansion (tracking.cpp:308-346): the
    #     reference extends the voted set with each member's best
    #     neighbors/children/parent before the cap-80 truncation.  Here:
    #     non-voted KFs ranked by their strongest covisibility link into
    #     the TOP-voted members fill the remaining cap slots (voted KFs
    #     keep priority via a large rank offset).  r5: the link score is
    #     max over the top-8 voted members' covisibility rows (observer
    #     index) — the reference's per-member best-neighbor walk — instead
    #     of the union-overlap count, whose [K,M] gather cost ~5 ms/frame.
    if cfg.tracking.local_map_expand:
        n_seed = min(8, k_cap)
        seed_rows = ms.covis_rows_fast(m, top_idx[:n_seed])   # [S,K]
        seed_ok = (top_vals[:n_seed] > 0)[:, None]
        link = jnp.max(jnp.where(seed_ok, seed_rows, 0), axis=0)
        exp_rank = jnp.where(
            m.kf_valid & ~local_kf & (link > 0), link.astype(votes.dtype),
            -1.0,
        )
        combined = jnp.where(local_kf, votes + 1e6, exp_rank)
        top_vals, top_idx = jax.lax.top_k(combined, k_cap)
        local_kf = jnp.zeros((K,), bool).at[top_idx].set(top_vals > 0)

    # 2. local landmarks: seen by local KFs, not already bound — gather
    #    only the local rows ([k_cap, M]), not the whole table
    local_lm = ms.landmark_mask_of_slots(m, top_idx, top_vals > 0)
    bound = jnp.zeros((L + 1,), bool).at[
        jnp.where(assoc >= 0, assoc, L)
    ].set(True)[:L]
    search_lm = local_lm & ~bound

    # 3. frustum check + guided projection match (tracking.cpp:368-405),
    #    over a COMPACTED candidate set (bounded by proj_match_cap, not L)
    vis, pred_uv, _, _ = camera.in_frustum(cam, frame.T_cw, m.lm_pos)
    cand = search_lm & vis
    cap = min(cfg.map.proj_match_cap, L)
    cidx, cvalid, n_overflow = matching.compact_candidates(cand, cap)
    pm = matching.projection_match(
        m.lm_desc[cidx], cvalid, pred_uv[cidx],
        frame.xy_und, frame.feat.desc, frame.feat.valid,
        frame.feat.octave, assoc < 0,
        radius=cfg.matcher.proj_radius,
        th_high=float(cfg.matcher.th_high),
        ratio=cfg.matcher.ratio_local,
    )
    # merge new bindings: landmark cidx[r] matched feature pm.target_idx[r]
    new_tgt = jnp.where(pm.valid, pm.target_idx, M)
    assoc2 = jnp.concatenate([assoc, jnp.full((1,), -1, jnp.int32)]) \
        .at[new_tgt].max(
            jnp.where(pm.valid, cidx, -1)
        )[:M]
    assoc2 = jnp.where(assoc >= 0, assoc, assoc2)

    # 4. pose-only BA over all bound landmarks (tracking.cpp:239).  With
    #    too few observations the 6-DoF solve is under-constrained and can
    #    throw the pose: keep the odometry pose unless >= 10 bindings
    #    support the refinement.
    lm_idx = jnp.where(assoc2 >= 0, assoc2, 0)
    pts_w = m.lm_pos[lm_idx]
    obs_valid = (assoc2 >= 0) & m.lm_valid[lm_idx] & frame.feat.valid
    if prior_weight is None:
        prior_weight = cfg.tracking.pose_prior_weight
    res = ba.pose_only_ba(
        frame.T_cw, pts_w, frame.xy_und, frame.ur, frame.depth,
        obs_valid, cam, cfg.ba,
        prior_weight=prior_weight,
    )
    enough = jnp.sum(obs_valid.astype(jnp.int32)) >= 10
    T_out = jnp.where(enough, res.T_cw, frame.T_cw)

    # 5. drop outlier bindings (DiscardOutliers/CleanVOmatches semantics)
    assoc_final = jnp.where(obs_valid & res.inliers, assoc2, -1)

    # 6. visibility/found statistics (landmark.cpp found/visible ratio)
    found = jnp.zeros((L + 1,), bool).at[
        jnp.where(assoc_final >= 0, assoc_final, L)
    ].set(True)[:L]
    return LocalMapResult(
        T_cw=T_out,
        assoc=assoc_final,
        n_tracked=jnp.sum((assoc_final >= 0).astype(jnp.int32)),
        visible_mask=cand | found,
        found_mask=found,
        local_kf_mask=local_kf,
        n_overflow=n_overflow,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def bootstrap_track(
    m: ms.MapState,
    frame: frame_mod.FrameData,
    cfg: SystemConfig,
):
    """Acquire landmark bindings with NO prior associations (sequence
    start after relocalization / multi-sequence anchoring): local map =
    pose-nearest keyframes, then a wide projection search + pose BA.
    Returns (T_cw, assoc, n_tracked)."""
    cam = cfg.camera
    K = m.kf_valid.shape[0]
    # nearest keyframes by camera-center distance
    d_t, _ = pose_distance(m.kf_T_cw, frame.T_cw)
    rank = jnp.where(m.kf_valid, -d_t, -jnp.inf)
    k_cap = min(10, K)
    top_vals, top_idx = jax.lax.top_k(rank, k_cap)
    local_kf = jnp.zeros((K,), bool).at[top_idx].set(top_vals > -jnp.inf)

    search_lm = ms.landmark_mask_of_kfs(m, local_kf)
    vis, pred_uv, _, _ = camera.in_frustum(cam, frame.T_cw, m.lm_pos)
    cand = search_lm & vis
    M = frame.xy_und.shape[0]
    L = m.lm_pos.shape[0]
    cidx, cvalid, _ = matching.compact_candidates(
        cand, min(cfg.map.proj_match_cap, L))
    pm = matching.projection_match(
        m.lm_desc[cidx], cvalid, pred_uv[cidx],
        frame.xy_und, frame.feat.desc, frame.feat.valid,
        frame.feat.octave, jnp.ones((M,), bool),
        radius=2.0 * cfg.matcher.proj_radius,   # wide: pose is approximate
        th_high=float(cfg.matcher.th_high),
        ratio=cfg.matcher.ratio_local,
    )
    new_tgt = jnp.where(pm.valid, pm.target_idx, M)
    assoc = jnp.full((M + 1,), -1, jnp.int32).at[new_tgt].max(
        jnp.where(pm.valid, cidx, -1)
    )[:M]

    lm_idx = jnp.where(assoc >= 0, assoc, 0)
    obs_valid = (assoc >= 0) & m.lm_valid[lm_idx] & frame.feat.valid
    res = ba.pose_only_ba(
        frame.T_cw, m.lm_pos[lm_idx], frame.xy_und, frame.ur, frame.depth,
        obs_valid, cam, cfg.ba,
    )
    assoc = jnp.where(obs_valid & res.inliers, assoc, -1)
    return res.T_cw, assoc, jnp.sum((assoc >= 0).astype(jnp.int32))


@functools.partial(jax.jit, donate_argnames=("m",))
def update_lm_stats(m: ms.MapState, visible_mask, found_mask) -> ms.MapState:
    return m._replace(
        lm_visible=m.lm_visible + visible_mask.astype(jnp.int32),
        lm_found=m.lm_found + found_mask.astype(jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def track_step(
    m: ms.MapState,
    last_frame: frame_mod.FrameData,
    last_assoc: jnp.ndarray,
    frame: frame_mod.FrameData,
    last_kf_T: jnp.ndarray,
    key: jnp.ndarray,
    cfg: SystemConfig,
):
    """The fused per-frame device program: frame-to-frame odometry +
    association carry + local-map tracking + landmark stats + keyframe
    trigger summary.  One dispatch, one host pull of a 6-scalar vector —
    the host round-trips of four separate calls collapse to one.

    Returns (map', pose T_cw, assoc, stats[7] =
    [n_tracked, n_matches, ransac_inliers, kf_dist, kf_rot, rmse,
    proj_overflow]).

    With cfg.use_gicp the odometry stage is the fused ADAPTIVE_RICP policy
    (RANSAC -> lax.cond GICP escalation, models/odometry.py:ricp_fused) —
    still one dispatch, no host scalar reads (VERDICT weak #5).
    """
    if cfg.use_gicp:
        from aslam.models.odometry import ricp_fused

        odo = ricp_fused(last_frame, frame, key, cfg)
    else:
        odo = rba_step(last_frame, frame, key, cfg)
    frame = frame_mod.with_pose(frame, odo.T_cw2)
    assoc = carry_associations(last_assoc, odo.match_idx, odo.inliers)
    # odometry/map fusion: the motion prior only applies when odometry
    # itself was healthy (a failed RANSAC must not anchor the pose)
    odo_ok = odo.n_inliers >= cfg.ransac.min_inliers
    w_prior = jnp.where(odo_ok, cfg.tracking.pose_prior_weight, 0.0)
    lm_res = track_local_map(m, frame, assoc, cfg, prior_weight=w_prior)
    m = update_lm_stats(m, lm_res.visible_mask, lm_res.found_mask)
    dt, dr = pose_distance(last_kf_T, lm_res.T_cw)
    stats = jnp.stack([
        lm_res.n_tracked.astype(jnp.float32),
        odo.n_matches.astype(jnp.float32),
        odo.n_inliers.astype(jnp.float32),
        dt, dr, odo.rmse,
        lm_res.n_overflow.astype(jnp.float32),
    ])
    return m, lm_res.T_cw, lm_res.assoc, stats


class Tracking:
    """Host-side orchestration of the per-frame pipeline."""

    def __init__(self, cfg: SystemConfig, seed: int = 0):
        self.cfg = cfg
        self.map = ms.init_map(cfg)
        self.adaptive = init_adaptive_state(cfg.extractor)
        self.key = jax.random.PRNGKey(seed)
        self.state = "NO_IMAGES"
        self.n_kfs = 0
        self.next_lm = 0
        self.kf_counter = 0
        self.last_frame: frame_mod.FrameData | None = None
        self.last_assoc: jnp.ndarray | None = None
        self.relocalizer = None  # set by SlamSystem when loop closing is on
        self.last_kf_T: np.ndarray | None = None
        self.last_kf_id: int = -1
        self.poses: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.new_kf_slots: list[int] = []
        self.stats: list[dict] = []
        # per-frame pose RELATIVE to the reference keyframe (the reference's
        # mlRelativeFramePoses + mlpReferences, tracking.cpp:407-413,544-582):
        # T_cw(t) is rebuilt at export time as T_cr(t) @ T_rw(final) so
        # BA/loop corrections propagate into the full trajectory.
        self.ref_kf_ids: list[int] = []
        self.rel_poses: list[np.ndarray] = []

    # -- keyframe insertion -------------------------------------------
    def _insert_keyframe(self, frame, assoc, max_new: int):
        # first free slot (reuses rows vacated by keyframe culling; the
        # temporal/covisibility structure is keyed on kf_id, not the slot)
        slot = jnp.argmin(self.map.kf_valid).astype(jnp.int32)
        kf_id = jnp.int32(self.kf_counter)
        self.map = ms.insert_keyframe(self.map, frame, assoc, slot, kf_id)
        self.map, assoc, n_created = ms.create_landmarks(
            self.map, frame, assoc, slot, kf_id,
            max_new=max_new, th_depth=float(self.cfg.camera.th_depth),
        )
        self.next_lm = int(jnp.sum(self.map.lm_valid))  # live count
        self.n_kfs = int(jnp.sum(self.map.kf_valid))
        self.last_kf_id = self.kf_counter
        self.kf_counter += 1
        self.last_kf_T = np.asarray(frame.T_cw)
        self.new_kf_slots.append(int(slot))
        return assoc

    def track(self, img: np.ndarray, depth: np.ndarray, t: float = 0.0):
        """Process one RGB-D frame; returns (T_cw ndarray, info dict)."""
        cfg = self.cfg
        frame, self.adaptive = frame_mod.make_frame(
            jnp.asarray(img, jnp.float32), jnp.asarray(depth, jnp.float32),
            cfg, self.adaptive,
        )
        info = {"new_kf": False}

        if self.state == "NO_IMAGES":
            frame = frame_mod.with_pose(frame, jnp.eye(4))
            assoc = jnp.full((cfg.extractor.max_keypoints,), -1, jnp.int32)
            assoc = self._insert_keyframe(frame, assoc,
                                          max_new=cfg.extractor.max_keypoints)
            self.state = "OK"
            info["new_kf"] = True
            info["n_tracked"] = int(jnp.sum(assoc >= 0))
        else:
            self.key, sub = jax.random.split(self.key)
            # one fused dispatch for both policies: ADAPTIVE_RBA, or
            # ADAPTIVE_RICP with the GICP escalation under lax.cond
            # (odometry.cpp:46-78) when cfg.use_gicp
            self.map, T_cw, assoc, stats_j = track_step(
                self.map, self.last_frame, self.last_assoc, frame,
                jnp.asarray(self.last_kf_T), sub, cfg,
            )
            stats = np.asarray(stats_j)  # the one per-frame sync
            frame = frame_mod.with_pose(frame, T_cw)

            n_tracked = int(stats[0])
            info.update(
                n_tracked=n_tracked,
                n_matches=int(stats[1]),
                ransac_inliers=int(stats[2]),
                proj_overflow=int(stats[6]),
            )

            # State machine (the reference declares LOST but never sets or
            # recovers it, SURVEY.md §5).  Two distinct failure modes:
            #
            #   WEAK — local-map tracking found < min_matches_tracked
            #          bindings but frame-to-frame odometry is healthy
            #          (RANSAC inliers >= the reference's own success bar,
            #          ransac min_inliers, odometry.cpp:14).  The camera is
            #          entering unmapped territory: keep integrating the
            #          odometry pose and KEEP inserting keyframes so the
            #          map grows into it.  Discarding the pose here (or
            #          blocking keyframes) death-spirals: no new landmarks
            #          -> local map stays empty -> permanent loss.
            #   LOST — odometry itself failed (sensor dropout, blur, no
            #          depth): relocalize, else motion-model + re-acquire.
            n_inliers = int(stats[2])
            odo_ok = n_inliers >= cfg.ransac.min_inliers
            if n_tracked < cfg.tracking.min_matches_tracked and odo_ok:
                self.state = "WEAK"
            elif n_tracked < cfg.tracking.min_matches_tracked:
                self.state = "LOST"
                if self.relocalizer is not None:
                    T_reloc = self.relocalizer.relocalize(self.map, frame)
                    if T_reloc is not None:
                        frame = frame_mod.with_pose(frame, jnp.asarray(T_reloc))
                        assoc = jnp.full_like(assoc, -1)
                        self.state = "OK"
                        info["relocalized"] = True
                if (self.state == "LOST"
                        and cfg.tracking.lost_policy == "motion_model"
                        and len(self.poses) >= 2):
                    # no relocalizer (or it failed): don't integrate the
                    # garbage estimate — substitute constant-velocity
                    # extrapolation, then try to RE-ACQUIRE map bindings at
                    # the predicted pose (pose-nearest KFs + wide projection
                    # search).  Without this the covisibility vote in
                    # track_local_map has no seed associations and the
                    # system would stay LOST forever.
                    T_pred = (self.poses[-1]
                              @ np.linalg.inv(self.poses[-2])
                              @ self.poses[-1])
                    frame = frame_mod.with_pose(frame, jnp.asarray(T_pred))
                    T_b, assoc_b, n_b = bootstrap_track(self.map, frame, cfg)
                    if int(n_b) >= cfg.tracking.min_matches_tracked:
                        frame = frame_mod.with_pose(frame, T_b)
                        assoc = assoc_b
                        self.state = "OK"
                        info["reacquired"] = True
                    else:
                        assoc = jnp.full_like(assoc, -1)
                        info["motion_model"] = True
            else:
                self.state = "OK"

            # keyframe decision (tracking.cpp:449-476); capacity check is
            # on live keyframes (culled slots are reusable)
            need = (
                stats[3] > cfg.tracking.kf_min_trans
                or stats[4] > cfg.tracking.kf_min_rot
            )
            if info.get("relocalized") or self.state == "LOST":
                # the pre-reloc pose delta is meaningless, and a LOST frame
                # must not spend a keyframe on an extrapolated pose
                need = False
            if need and self.n_kfs < cfg.map.max_keyframes:
                assoc = self._insert_keyframe(
                    frame, assoc, max_new=cfg.tracking.max_vo_points
                )
                info["new_kf"] = True

        self.last_frame = frame
        self.last_assoc = assoc
        T = np.asarray(frame.T_cw)
        self.poses.append(T)
        self.timestamps.append(t)
        self.stats.append(info)
        self.record_relative_pose(T)
        return T, info

    def record_relative_pose(self, T_cw: np.ndarray) -> None:
        """Append this frame's (reference-KF id, T_cr) record.  When the
        frame itself became a keyframe, last_kf_T is its own pose and the
        relative pose is the identity (UpdateRelativePose,
        tracking.cpp:407-413)."""
        T_rw = self.last_kf_T if self.last_kf_T is not None else np.eye(4)
        self.ref_kf_ids.append(self.last_kf_id)
        self.rel_poses.append(np.asarray(T_cw) @ np.linalg.inv(T_rw))
