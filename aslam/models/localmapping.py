"""Local mapping: per-keyframe map refinement.

Replaces `System/localmapping.{h,cpp}` (SURVEY.md component 3).  The
reference runs this as a background pthread consuming a keyframe queue
(localmapping.cpp:28-52); here each inserted keyframe triggers one
bounded sequence of jitted map updates — pipeline concurrency comes from
JAX's async dispatch (the host thread never blocks on these unless it
reads a scalar), not from shared-memory locking:

  1. refresh distinctive descriptors of touched landmarks
     (ComputeDistinctiveDescriptors, landmark.cpp:219-273)
  2. landmark culling (localmapping.cpp:110-134)
  3. fuse: project neighbor landmarks into the new KF, merge duplicates
     (FuseLandmarks, localmapping.cpp:136-194 + Matcher::Fuse
     matcher.cpp:212-313)
  4. local BA over the covisibility window (Schur LM, ops/lba.py)
  5. keyframe culling (localmapping.cpp:196-238)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import SystemConfig
from aslam.models import mapstate as ms
from aslam.ops import lba, matching
from aslam.utils import camera


# ------------------------------------------------------------------ fuse

@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def fuse_landmarks(m: ms.MapState, slot: jnp.ndarray,
                   cfg: SystemConfig) -> ms.MapState:
    """Project landmarks seen by covisible KFs into keyframe `slot`; bind
    them to free features, and when a feature is already bound, merge the
    two landmarks keeping the better-observed one (Replace,
    landmark.cpp:160-192).  One batched round per insertion."""
    cam = cfg.camera
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]

    w_row = ms.covis_row_fast(m, slot)                             # [K]
    n_cap = min(64, K)
    nb_vals, nb_idx = jax.lax.top_k(
        jnp.where(m.kf_valid, w_row, -1), n_cap)
    nb_ok = nb_vals >= cfg.map.covis_min_weight
    cand = ms.landmark_mask_of_slots(m, nb_idx, nb_ok)

    # exclude landmarks already bound in this KF
    own = m.kf_lm[slot]
    own_mask = jnp.zeros((L + 1,), bool).at[
        jnp.where(own >= 0, own, L)
    ].set(True)[:L]
    cand = cand & ~own_mask

    T_kf = m.kf_T_cw[slot]
    vis, pred_uv, _, _ = camera.in_frustum(cam, T_kf, m.lm_pos)
    cand = cand & vis

    cidx, cvalid, _ = matching.compact_candidates(
        cand, min(cfg.map.proj_match_cap, L))
    pm = matching.projection_match(
        m.lm_desc[cidx], cvalid, pred_uv[cidx],
        m.kf_xy[slot], m.kf_desc[slot], m.kf_kp_valid[slot],
        m.kf_octave[slot], jnp.ones((M,), bool),  # bound features allowed
        radius=cfg.matcher.fuse_radius,
        th_high=float(cfg.matcher.th_low),        # Fuse uses TH_LOW
        ratio=1.0,                                # no ratio test in Fuse
    )

    tgt_feat = jnp.where(pm.valid, pm.target_idx, M)
    own_pad = jnp.concatenate([own, jnp.full((1,), -1, jnp.int32)])
    existing = own_pad[tgt_feat]                      # [cap] bound lm or -1

    lm_ids = cidx                                     # [cap] global lm ids
    # case A: feature free -> bind landmark
    bind = pm.valid & (existing < 0)
    new_row = own_pad.at[jnp.where(bind, tgt_feat, M)].set(
        jnp.where(bind, lm_ids, -1)
    )[:M]

    # case B: feature bound to other landmark -> merge (keep more obs),
    # on a COMPACT pair set — obs counts come from the observer index
    # for just the pair landmarks instead of a full-map histogram (r5)
    dup = pm.valid & (existing >= 0) & (existing != lm_ids)
    P = min(512, dup.shape[0])
    dup_idx, dup_ok, _ = matching.compact_candidates(dup, P)
    ex_d = jnp.maximum(existing[dup_idx], 0)          # [P]
    new_d = lm_ids[dup_idx]
    _, _, ok_ex = ms.observer_entries(m, ex_d, dup_ok)
    _, _, ok_new = ms.observer_entries(m, new_d, dup_ok)
    keep_existing = jnp.sum(ok_ex, axis=1) >= jnp.sum(ok_new, axis=1)
    loser = jnp.where(dup_ok, jnp.where(keep_existing, new_d, ex_d), L)
    winner = jnp.where(dup_ok, jnp.where(keep_existing, ex_d, new_d), L)
    redirect = jnp.arange(L + 1, dtype=jnp.int32).at[loser].set(winner)[:L + 1]
    redirect = redirect.at[L].set(-1)

    lm_valid = jnp.concatenate([m.lm_valid, jnp.zeros((1,), bool)]) \
        .at[loser].set(False)[:L]

    # apply redirect to every observation slot (landmark Replace cascade as
    # one gather)
    kf_lm = m.kf_lm.at[slot].set(new_row)
    kf_lm = redirect[jnp.where(kf_lm >= 0, kf_lm, L)]

    m = m._replace(kf_lm=kf_lm, lm_valid=lm_valid)

    # --- observer-index maintenance (r5) ---
    # bind case: the new (slot, feature) bindings
    m = ms.append_observations(
        m, jnp.where(bind, lm_ids, 0),
        jnp.where(bind, pm.target_idx, 0), slot, bind)
    # merge case: the loser's surviving observer entries now bind the
    # winner (via the kf_lm redirect) but live only in the loser's list —
    # copy them into the winner's ring so covisibility stays exact.
    # Bounded to the P merge pairs per fuse round (typical: dozens).
    losers = loser
    winners = winner
    O = m.lm_obs_kf.shape[1]
    okf_pad = jnp.concatenate([m.lm_obs_kf, jnp.full((1, O), -1, jnp.int32)])
    ofe_pad = jnp.concatenate([m.lm_obs_feat, jnp.zeros((1, O), jnp.int32)])
    ptr_pad = jnp.concatenate([m.lm_obs_ptr, jnp.zeros((1,), jnp.int32)])
    lokf = okf_pad[jnp.where(dup_ok, losers, L)]          # [P,O]
    lofe = ofe_pad[jnp.where(dup_ok, losers, L)]
    kfs = jnp.maximum(lokf, 0)
    ent_ok = (lokf >= 0) & m.kf_valid[kfs] \
        & (kf_lm[kfs, lofe] == winners[:, None])
    off = jnp.cumsum(ent_ok.astype(jnp.int32), axis=1) - 1
    wptr = ptr_pad[winners]
    pos = (wptr[:, None] + off) % O
    tgt_w = jnp.where(ent_ok, winners[:, None], L)
    okf_new = okf_pad.at[tgt_w, pos].set(
        jnp.where(ent_ok, lokf, -1))[:L]
    ofe_new = ofe_pad.at[tgt_w, pos].set(lofe)[:L]
    ptr_new = ptr_pad.at[winners].add(
        jnp.sum(ent_ok.astype(jnp.int32), axis=1))[:L]
    return m._replace(lm_obs_kf=okf_new, lm_obs_feat=ofe_new,
                      lm_obs_ptr=ptr_new)


# ------------------------------------------------------------- local BA

class WindowSpec(NamedTuple):
    cam_slots: jnp.ndarray   # [C] int32 KF slots in the problem
    cam_fixed: jnp.ndarray   # [C] bool
    cam_valid: jnp.ndarray   # [C] bool


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_window(m: ms.MapState, slot: jnp.ndarray, cfg: SystemConfig):
    """Select the BA window: current KF + top-covisible KFs (optimized) and
    the most-connected remaining KFs as fixed anchors
    (localbundleadjustment.cpp:21-63, capped to static shapes)."""
    K = m.kf_valid.shape[0]
    n_win = cfg.ba.max_window_cams
    n_fix = cfg.ba.max_fixed_cams
    w_row = jnp.where(m.kf_valid, ms.covis_row_fast(m, slot), -1)
    w_row = w_row.at[slot].set(-1)

    win_vals, win_idx = jax.lax.top_k(w_row, min(n_win - 1, K))
    cam_slots_w = jnp.concatenate([slot[None], win_idx])[:n_win]
    # reference window = covisibility-CONNECTED KFs (edge weight >= 15,
    # keyframe.cpp:165 via GetVectorCovisibleKeyFrames) — NOT every KF
    # sharing a single landmark.  Weight > 0 would pull nearly the whole
    # map into the optimized set in a small scene (a near-global BA with
    # one gauge anchor at every insertion), which smears accumulated drift
    # across the chain instead of keeping refinement local.
    th_w = float(cfg.map.covis_min_weight)
    valid_w = jnp.concatenate(
        [jnp.ones((1,), bool), win_vals >= th_w])[:n_win]
    # reference fallback (keyframe.cpp:180-183): when no neighbor reaches
    # th_w, connect the single max-weight neighbor so the window never
    # collapses to the current KF alone in low-covisibility stretches
    no_conn = ~jnp.any(win_vals >= th_w)
    valid_w = valid_w.at[1].set(valid_w[1] | (no_conn & (win_vals[0] > 0)))

    # fixed anchors: remaining KFs most covisible with any window KF
    # (scatter invalid entries to a scratch slot so they can't clobber
    # row 0).  Covisibility columns only for the window slots — n_win
    # O(K*M) row gathers, no full [K,K] product.
    in_win = jnp.zeros((K + 1,), bool).at[
        jnp.where(valid_w, cam_slots_w, K)
    ].set(True)[:K]
    W_win = ms.covis_rows_fast(m, cam_slots_w)       # [n_win, K]
    anchor_score = jnp.where(
        m.kf_valid & ~in_win,
        jnp.max(W_win * valid_w[:, None], axis=0),
        -1,
    )
    fix_vals, fix_idx = jax.lax.top_k(anchor_score, min(n_fix, K))
    valid_f = fix_vals > 0
    # always anchor the oldest KF (gauge) if not already in the window
    oldest = jnp.argmax(jnp.where(m.kf_valid, -m.kf_id, -(2**30)))
    fix_idx = fix_idx.at[0].set(
        jnp.where(in_win[oldest], fix_idx[0], oldest)
    )
    valid_f = valid_f.at[0].set(valid_f[0] | ~in_win[oldest])

    cam_slots = jnp.concatenate([cam_slots_w, fix_idx])
    cam_valid = jnp.concatenate([valid_w, valid_f])
    # gauge: when the whole map fits in the window there are no outside
    # anchors — pin the oldest in-window KF instead (otherwise the damped
    # solve would drift the global frame)
    has_anchor = jnp.any(valid_f)
    fix_w = (cam_slots_w == oldest) & valid_w & ~has_anchor
    cam_fixed = jnp.concatenate([fix_w, jnp.ones((n_fix,), bool)])
    # single-KF maps: fix the only camera
    cam_fixed = cam_fixed.at[0].set(
        cam_fixed[0] | (jnp.sum(m.kf_valid) <= 1)
    )
    return WindowSpec(cam_slots, cam_fixed, cam_valid)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_chain(m: ms.MapState, spec: WindowSpec,
                cfg: SystemConfig) -> lba.ChainSpec:
    """Odometry-chain edges between temporally consecutive window cams,
    anchored at their CURRENT relative transforms (the tracked,
    prior-fused chain) — see ops/lba.ChainSpec."""
    from aslam.utils.se3 import T_inv

    ids = jnp.where(spec.cam_valid, m.kf_id[spec.cam_slots], 2**30)
    order = jnp.argsort(ids).astype(jnp.int32)
    c_i = order[:-1]
    c_j = order[1:]
    both = (ids[c_i] < 2**30) & (ids[c_j] < 2**30)
    # temporal-adjacency gate: consecutive-in-sorted-order is not enough —
    # a revisit pulls covisibility neighbors with kf_ids hundreds apart
    # into the window, and anchoring THOSE pairs at the current (drifted)
    # relative transform would fight the reprojection evidence that should
    # align old and new map segments.  Only near-adjacent ids (gap <=
    # chain_max_gap, allowing for culled intermediates) carry the prior.
    adjacent = (ids[c_j] - ids[c_i]) <= cfg.ba.chain_max_gap
    T = m.kf_T_cw[spec.cam_slots]
    meas = T[c_i] @ T_inv(T[c_j])
    w = jnp.where(both & adjacent, cfg.ba.chain_prior_weight, 0.0)
    return lba.ChainSpec(c_i=c_i, c_j=c_j, c_meas=meas, c_w=w)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_problem(m: ms.MapState, spec: WindowSpec, cfg: SystemConfig):
    """Extract the BAProblem arrays for the window.  Edges are the window
    KFs' feature slots (static shape C*M, masked).

    The window's landmarks are gathered into a COMPACT local index space of
    capacity `cfg.ba.max_window_points` (Lw) before assembly: the Schur
    coupling tensor W is [C,Lw,6,3] instead of [C,L_total,6,3] — at default
    capacities that is ~25x less memory for a window that touches a few
    thousand of the map's 32k landmark slots (the windowing intent of
    reference localbundleadjustment.cpp:21-63).

    Returns (BAProblem, lw_ids [Lw] global landmark ids, n_overflow scalar
    int32 = optimizable landmarks that did not fit in Lw and therefore keep
    their current positions).
    """
    C = spec.cam_slots.shape[0]
    M = m.kf_lm.shape[1]
    L = m.lm_pos.shape[0]
    Lw = cfg.ba.max_window_points

    rows = m.kf_lm[spec.cam_slots]                   # [C,M]
    kp_ok = m.kf_kp_valid[spec.cam_slots] & spec.cam_valid[:, None]
    has = (rows >= 0) & kp_ok
    lm_idx = jnp.where(has, rows, 0)

    # optimizable landmarks: observed by a non-fixed window cam
    win_obs = jnp.zeros((L + 1,), bool).at[
        jnp.where(has & ~spec.cam_fixed[:, None], rows, L)
    ].set(True)[:L]
    point_opt = win_obs & m.lm_valid

    # gather into compact local space: optimizable landmarks in stable id
    # order (nonzero-with-size = prefix sum + bounded scatter; the full
    # argsort over the landmark table cost ~2 ms at L=64k, r5)
    n_opt = jnp.sum(point_opt.astype(jnp.int32))
    (lw_ids,) = jnp.nonzero(point_opt, size=Lw, fill_value=0)
    lw_ids = lw_ids.astype(jnp.int32)
    lw_valid = jnp.arange(Lw) < n_opt
    n_overflow = jnp.maximum(n_opt - Lw, 0)
    # global -> local lookup (-1 = not in the window)
    g2l = jnp.full((L + 1,), -1, jnp.int32).at[
        jnp.where(lw_valid, lw_ids, L)
    ].set(jnp.where(lw_valid, jnp.arange(Lw, dtype=jnp.int32), -1))[:L]

    # fixed-cam edges only constrain window landmarks; non-window-landmark
    # edges are masked out (they would distort the Schur complement)
    e_lm_local = g2l[lm_idx]                          # [C,M]
    e_valid = has & m.lm_valid[lm_idx] & (e_lm_local >= 0)

    prob = lba.BAProblem(
        cam_T=m.kf_T_cw[spec.cam_slots],
        cam_fixed=spec.cam_fixed,
        cam_valid=spec.cam_valid,
        points=m.lm_pos[lw_ids],
        point_valid=lw_valid,
        e_cam=jnp.repeat(jnp.arange(C, dtype=jnp.int32), M),
        e_lm=jnp.maximum(e_lm_local, 0).reshape(-1),
        e_uv=m.kf_xy[spec.cam_slots].reshape(-1, 2),
        e_ur=m.kf_ur[spec.cam_slots].reshape(-1),
        e_z=m.kf_z[spec.cam_slots].reshape(-1),
        e_valid=e_valid.reshape(-1),
    )
    return prob, lw_ids, n_overflow


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def write_back(m: ms.MapState, spec: WindowSpec, prob: lba.BAProblem,
               lw_ids: jnp.ndarray, cfg: SystemConfig) -> ms.MapState:
    """Write optimized poses/points back and erase pruned observations
    (lba.cpp:288-315, under the reference's map-update mutex — here just
    array writes).  `lw_ids` maps the problem's compact landmark index
    space back to global landmark ids (from build_problem)."""
    C, M = spec.cam_slots.shape[0], m.kf_lm.shape[1]
    L = m.lm_pos.shape[0]
    write_cam = spec.cam_valid & ~spec.cam_fixed
    safe_slots = jnp.where(write_cam, spec.cam_slots, m.kf_T_cw.shape[0])
    kf_T = jnp.concatenate([m.kf_T_cw, jnp.zeros((1, 4, 4))]) \
        .at[safe_slots].set(prob.cam_T)[:-1]

    # scatter optimized positions back to the global table
    safe_lw = jnp.where(prob.point_valid, lw_ids, L)
    lm_pos = jnp.concatenate([m.lm_pos, jnp.zeros((1, 3))]) \
        .at[safe_lw].set(prob.points)[:L]

    # pruned edges -> remove observation (kf_lm slot := -1); only window
    # landmarks can be pruned (others were never in the problem)
    point_opt_g = jnp.zeros((L + 1,), bool).at[safe_lw].set(
        prob.point_valid
    )[:L]
    pruned = (~prob.e_valid.reshape(C, M)) & (m.kf_lm[spec.cam_slots] >= 0) \
        & spec.cam_valid[:, None] & point_opt_g[
            jnp.maximum(m.kf_lm[spec.cam_slots], 0)
        ]
    rows = jnp.where(pruned, -1, m.kf_lm[spec.cam_slots])
    kf_lm = m.kf_lm.at[spec.cam_slots[:, None], jnp.arange(M)[None, :]].set(
        jnp.where(spec.cam_valid[:, None], rows, m.kf_lm[spec.cam_slots])
    )

    return m._replace(kf_T_cw=kf_T, lm_pos=lm_pos, kf_lm=kf_lm)


# ------------------------------------------------- fused device program

def empty_cull_info() -> ms.CullInfo:
    """CullInfo [3] placeholder (no culls) — the untaken-branch value."""
    return ms.CullInfo(
        culled=jnp.zeros((3,), bool),
        kf_id=jnp.full((3,), -1, jnp.int32),
        parent_kf_id=jnp.full((3,), -1, jnp.int32),
        T_cp=jnp.tile(jnp.eye(4)[None], (3, 1, 1)),
    )


def empty_cull_info_single() -> ms.CullInfo:
    """Scalar CullInfo placeholder (one no-op culling round)."""
    return ms.CullInfo(
        culled=jnp.asarray(False),
        kf_id=jnp.int32(-1),
        parent_kf_id=jnp.int32(-1),
        T_cp=jnp.eye(4),
    )


def map_keyframe_body(m: ms.MapState, slot: jnp.ndarray,
                      kf_id: jnp.ndarray, cfg: SystemConfig):
    """The WHOLE per-keyframe refinement sequence as pure traced code:
    descriptor refresh -> landmark culling -> fuse -> position refresh ->
    windowed LBA (under lax.cond, >2 live KFs) -> keyframe culling (<=3
    victims/insertion).  Zero host scalar reads — the device-resident
    counterpart of LocalMapping.process_keyframe (reference background
    thread, localmapping.cpp:28-52).  models/device_slam.py inlines this
    into the keyframe-insertion branch of the per-frame scan, so mapping
    runs at device rate with no dispatch or readback per keyframe.

    Returns (map', CullInfo with leading axis 3 — the per-round culled-KF
    parent-chain records, `culled` False on no-op rounds)."""
    row = m.kf_lm[slot]
    m = ms.refresh_landmark_descriptors_ids(
        m, jnp.maximum(row, 0), (row >= 0) & m.kf_kp_valid[slot])
    if cfg.map.lm_cull_every <= 1:
        m = ms.landmark_culling(m, kf_id, cfg)
    else:
        m = jax.lax.cond(
            kf_id % cfg.map.lm_cull_every == 0,
            lambda mm: ms.landmark_culling(mm, kf_id, cfg),
            lambda mm: mm, m)
    m = fuse_landmarks(m, slot, cfg)
    if cfg.map.refresh_positions:
        row2 = m.kf_lm[slot]    # post-fuse: includes newly bound landmarks
        m = ms.refresh_landmark_positions_ids(
            m, jnp.maximum(row2, 0),
            (row2 >= 0) & m.kf_kp_valid[slot], cfg)
        if cfg.map.global_refresh_every > 0:
            # periodic FULL-map refresh: propagates accumulated pose
            # motion (LBA, corrections) into every landmark, which the
            # touched-ids pass alone does not (r5 session A/B: dropping
            # it cost ~45% session ATE)
            m = jax.lax.cond(
                kf_id % cfg.map.global_refresh_every == 0,
                lambda mm: ms.refresh_landmark_positions(mm, cfg),
                lambda mm: mm, m)
    if cfg.map.enable_local_ba:
        def do_lba(m):
            spec = build_window(m, slot, cfg)
            prob, lw_ids, _ = build_problem(m, spec, cfg)
            chain = (build_chain(m, spec, cfg)
                     if cfg.ba.chain_prior_weight > 0 else None)
            prob, _ = lba.local_ba(prob, cfg.camera, cfg.ba, chain=chain,
                                   group=m.kf_lm.shape[1])
            return write_back(m, spec, prob, lw_ids, cfg)

        gate_lba = jnp.sum(m.kf_valid.astype(jnp.int32)) > 2
        if cfg.map.lba_every > 1:
            gate_lba = gate_lba & (kf_id % cfg.map.lba_every == 0)
        m = jax.lax.cond(gate_lba, do_lba, lambda mm: mm, m)
    infos = []
    rounds = max(cfg.map.kf_cull_rounds, 1)
    gate = (kf_id % cfg.map.kf_cull_every == 0) \
        if cfg.map.kf_cull_every > 1 else None
    for _ in range(3):
        # each call culls at most one victim and no-ops when none
        # remain — `rounds` unconditional rounds == the host loop's cap.
        # CullInfo stays a [3] record for a stable scan-output shape.
        if len(infos) < rounds:
            if gate is None:
                m, cull = ms.keyframe_culling(m, slot, cfg)
            else:
                def do_cull(mm):
                    return ms.keyframe_culling(mm, slot, cfg)

                def skip_cull(mm):
                    return mm, empty_cull_info_single()

                m, cull = jax.lax.cond(gate, do_cull, skip_cull, m)
        else:
            cull = empty_cull_info_single()
        infos.append(cull)
    return m, jax.tree.map(lambda *xs: jnp.stack(xs), *infos)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def map_keyframe_fused(m: ms.MapState, slot: jnp.ndarray,
                       kf_id: jnp.ndarray, cfg: SystemConfig):
    """Standalone-dispatch wrapper of `map_keyframe_body` with an
    alive-guard: the body no-ops (and returns empty cull records) when
    `slot` no longer holds `kf_id` — a fresh keyframe can be culled by an
    earlier mapping dispatch in the same sync window."""

    def body(m):
        return map_keyframe_body(m, slot, kf_id, cfg)

    def skip(m):
        return m, empty_cull_info()

    alive = m.kf_valid[slot] & (m.kf_id[slot] == kf_id)
    return jax.lax.cond(alive, body, skip, m)


# ------------------------------------------------------------ orchestration

class LocalMapping:
    """Host driver for the per-keyframe refinement sequence."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.n_processed = 0
        # culled-KF parent chain: kf_id -> (parent_kf_id, T_cp [4,4]).
        # Trajectory recovery walks this to a surviving ancestor when a
        # frame's reference KF was culled (tracking.cpp:564-567,
        # keyframe.cpp:506 `mTcp`).
        self.culled: dict[int, tuple[int, np.ndarray]] = {}

    def process_keyframe(self, m: ms.MapState, slot: int, kf_id: int,
                         n_kfs: int) -> ms.MapState:
        cfg = self.cfg
        slot_j = jnp.int32(slot)

        # 1. distinctive descriptors for landmarks touched by this KF
        row = m.kf_lm[slot_j]
        m = ms.refresh_landmark_descriptors_ids(
            m, jnp.maximum(row, 0), (row >= 0) & m.kf_kp_valid[slot_j])

        # 2. landmark culling (on the configured cadence)
        if kf_id % max(cfg.map.lm_cull_every, 1) == 0:
            m = ms.landmark_culling(m, jnp.int32(kf_id), cfg)

        # 3. fuse duplicates with covisible neighbors
        m = fuse_landmarks(m, slot_j, cfg)

        # 3b. closed-form multi-view position refresh (depth-noise
        # averaging across observing KFs; also the LBA linearization point)
        if cfg.map.refresh_positions:
            row2 = m.kf_lm[slot_j]
            m = ms.refresh_landmark_positions_ids(
                m, jnp.maximum(row2, 0),
                (row2 >= 0) & m.kf_kp_valid[slot_j], cfg)
            if (cfg.map.global_refresh_every > 0
                    and kf_id % cfg.map.global_refresh_every == 0):
                m = ms.refresh_landmark_positions(m, cfg)

        # 4. local BA once there are >2 KFs (localmapping.cpp:45-48)
        if cfg.map.enable_local_ba and n_kfs > 2 \
                and kf_id % max(cfg.map.lba_every, 1) == 0:
            spec = build_window(m, slot_j, cfg)
            prob, lw_ids, _ = build_problem(m, spec, cfg)
            chain = (build_chain(m, spec, cfg)
                     if cfg.ba.chain_prior_weight > 0 else None)
            prob, _ = lba.local_ba(prob, cfg.camera, cfg.ba, chain=chain,
                                   group=m.kf_lm.shape[1])
            m = write_back(m, spec, prob, lw_ids, cfg)

        # 5. keyframe culling (scalar readbacks at KF rate, not frame rate).
        # The device kernel removes one victim per call; the reference's
        # pass can erase several redundant KFs (localmapping.cpp:196-238),
        # so loop until no victim remains, bounded per insertion.
        rounds = (max(cfg.map.kf_cull_rounds, 1)
                  if kf_id % max(cfg.map.kf_cull_every, 1) == 0 else 0)
        for _ in range(rounds):
            m, cull = ms.keyframe_culling(m, slot_j, cfg)
            if not bool(cull.culled):
                break
            self.culled[int(cull.kf_id)] = (
                int(cull.parent_kf_id), np.asarray(cull.T_cp),
            )
        self.n_processed += 1
        return m
