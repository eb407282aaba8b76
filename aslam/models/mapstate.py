"""MapState: the world model as a pytree of fixed-capacity arrays.

Replaces the reference Core/ layer (Frame/KeyFrame/Landmark/Map,
SURVEY.md components 5-8): a pointer graph with 19 mutexes becomes plain
arrays + tombstone masks, and every derived structure the reference
maintains incrementally (covisibility graph `UpdateConnections`
keyframe.cpp:130-206, observation counts, distinctive descriptors
landmark.cpp:219-273) is *recomputed* from the source-of-truth arrays with
one batched op — always consistent, no mutation cascades (`SetBadFlag`
keyframe.cpp:429-512 becomes a mask write).

Source of truth:
  kf_* rows      — one per keyframe slot (pose + keypoint arrays)
  kf_lm [K,M]    — landmark id per keyframe feature slot (-1 = none).
                   This IS the observation edge list in COO-by-row form.
  lm_* rows      — one per landmark slot (position, descriptor, stats)

Derived on demand:
  observation counts  = segment-count of kf_lm
  covisibility matrix = A A^T over the binary KF x landmark incidence (GEMM)
  distinctive descriptor = min-total-Hamming medoid over observations
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import SystemConfig
from aslam.models.frame import FrameData
from aslam.ops import hamming
from aslam.utils import camera
from aslam.utils.se3 import T_inv, transform_points


class MapState(NamedTuple):
    # keyframes
    kf_T_cw: jnp.ndarray     # [K,4,4]
    kf_valid: jnp.ndarray    # [K] bool
    kf_id: jnp.ndarray       # [K] int32 insertion order (monotonic)
    kf_xy: jnp.ndarray       # [K,M,2] undistorted keypoint coords
    kf_ur: jnp.ndarray       # [K,M]
    kf_z: jnp.ndarray        # [K,M] keypoint depth
    kf_desc: jnp.ndarray     # [K,M,8] uint32
    kf_octave: jnp.ndarray   # [K,M] int32
    kf_kp_valid: jnp.ndarray # [K,M] bool
    kf_lm: jnp.ndarray       # [K,M] int32 landmark id, -1 = none
    # landmarks
    lm_pos: jnp.ndarray      # [L,3] world position
    lm_desc: jnp.ndarray     # [L,8] uint32 distinctive descriptor
    lm_valid: jnp.ndarray    # [L] bool
    lm_first_kf: jnp.ndarray # [L] int32 kf_id at creation
    lm_visible: jnp.ndarray  # [L] int32 frustum-visible count
    lm_found: jnp.ndarray    # [L] int32 tracked-inlier count
    # landmark -> observer reverse index (r5): up to O (kf_slot, feat_idx)
    # pairs per landmark, appended at binding time, ring-overwritten past O.
    # Entries are SELF-INVALIDATING — an entry counts only while
    # kf_valid[kf] & (kf_lm[kf, feat] == l) still holds — so culls, fuse
    # redirects, LBA observation prunes, and slot reuse never need to
    # touch the lists.  Motivation: covisibility votes walk
    # ids->observers in O(N*O) instead of a [K,M]-wide gather/scatter.
    # (defaults None so geometry-only constructions — e.g. the sharded
    # GN-CG local views — need not carry them; every engine path built
    # via init_map has real arrays)
    lm_obs_kf: jnp.ndarray = None   # [L,O] int32 KF slot (-1 = empty)
    lm_obs_feat: jnp.ndarray = None # [L,O] int32 feature index
    lm_obs_ptr: jnp.ndarray = None  # [L] int32 ring write cursor


def init_map(cfg: SystemConfig) -> MapState:
    K = cfg.map.max_keyframes
    L = cfg.map.max_landmarks
    M = cfg.extractor.max_keypoints
    return MapState(
        kf_T_cw=jnp.tile(jnp.eye(4), (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_id=jnp.full((K,), -1, jnp.int32),
        kf_xy=jnp.zeros((K, M, 2)),
        kf_ur=jnp.full((K, M), -1.0),
        kf_z=jnp.zeros((K, M)),
        kf_desc=jnp.zeros((K, M, 8), jnp.uint32),
        kf_octave=jnp.zeros((K, M), jnp.int32),
        kf_kp_valid=jnp.zeros((K, M), bool),
        kf_lm=jnp.full((K, M), -1, jnp.int32),
        lm_pos=jnp.zeros((L, 3)),
        lm_desc=jnp.zeros((L, 8), jnp.uint32),
        lm_valid=jnp.zeros(L, bool),
        lm_first_kf=jnp.full((L,), -1, jnp.int32),
        lm_visible=jnp.zeros(L, jnp.int32),
        lm_found=jnp.zeros(L, jnp.int32),
        lm_obs_kf=jnp.full((L, cfg.map.max_obs_per_lm), -1, jnp.int32),
        lm_obs_feat=jnp.zeros((L, cfg.map.max_obs_per_lm), jnp.int32),
        lm_obs_ptr=jnp.zeros((L,), jnp.int32),
    )


# ---------------------------------------------------------------- derived

def observation_counts(m: MapState) -> jnp.ndarray:
    """[L] int32: number of observing KEYFRAMES per landmark (used for
    covisibility-style logic; for the reference's doubled nObs statistic
    see observation_counts_weighted)."""
    L = m.lm_pos.shape[0]
    ids = jnp.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_lm, -1)
    flat = jnp.where(ids >= 0, ids, L).reshape(-1)
    return jnp.zeros((L + 1,), jnp.int32).at[flat].add(1)[:L]


def observation_counts_weighted(m: MapState) -> jnp.ndarray:
    """[L] int32: the reference's nObs statistic — observations with valid
    depth count TWICE (pseudo-stereo = two constraints, landmark.cpp:69-80);
    monocular observations count once.  Used by landmark culling so the
    obs<=3 rule matches reference behavior exactly: one stereo observation
    (nObs=2) dies, two stereo observations (nObs=4) survive."""
    L = m.lm_pos.shape[0]
    ids = jnp.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_lm, -1)
    w = jnp.where(m.kf_z > 0, 2, 1).astype(jnp.int32)
    flat = jnp.where(ids >= 0, ids, L).reshape(-1)
    return jnp.zeros((L + 1,), jnp.int32).at[flat].add(w.reshape(-1))[:L]


def incidence(m: MapState) -> jnp.ndarray:
    """[K,L] bool: KF k observes landmark l.

    SCALE WARNING: materializes the full K x L matrix (10 GB at the 10k-KF
    contract).  The live pipeline never calls this — per-frame/per-KF paths
    use the O(K*M) primitives below (kf_votes / landmark_mask_of_kfs /
    covis_row); it remains for small-map utilities and tests."""
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]
    ids = jnp.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_lm, -1)
    flat = jnp.where(ids >= 0, ids, L)
    A = jnp.zeros((K, L + 1), bool)
    A = A.at[jnp.arange(K)[:, None], flat].set(True)
    return A[:, :L] & m.lm_valid[None, :]


def landmark_mask_of_kfs(m: MapState, kf_mask: jnp.ndarray) -> jnp.ndarray:
    """[L] bool: landmarks observed by any KF in `kf_mask` — one [K,M]
    scatter, never materializing the [K,L] incidence."""
    L = m.lm_pos.shape[0]
    ok = m.kf_kp_valid & (m.kf_valid & kf_mask)[:, None] & (m.kf_lm >= 0)
    flat = jnp.where(ok, m.kf_lm, L).reshape(-1)
    return jnp.zeros((L + 1,), bool).at[flat].set(True)[:L] & m.lm_valid


def kf_votes(m: MapState, lm_mask: jnp.ndarray) -> jnp.ndarray:
    """[K] int32: per-KF count of observed landmarks inside `lm_mask` —
    one [K,M] gather (the covisibility-vote primitive; replaces the
    incidence matvec of tracking.cpp:263-307 at any map scale)."""
    pad = jnp.concatenate([lm_mask & m.lm_valid, jnp.zeros((1,), bool)])
    # kf_lm == -1 wraps to index L (the padding row) under JAX semantics
    hit = pad[m.kf_lm] & m.kf_kp_valid & m.kf_valid[:, None]
    return jnp.sum(hit, axis=1, dtype=jnp.int32)


def append_observations(m: MapState, lm_ids: jnp.ndarray,
                        feat_idx: jnp.ndarray, slot: jnp.ndarray,
                        mask: jnp.ndarray) -> MapState:
    """Record (slot, feat_idx[i]) as an observer of landmark lm_ids[i] for
    every masked i (ring append into lm_obs_*).  Caller contract: each
    (kf, feat) binding is appended exactly ONCE over its lifetime, and
    lm_ids contains no duplicates among masked entries (one landmark binds
    at most one feature of a frame)."""
    L, O = m.lm_obs_kf.shape
    tgt = jnp.where(mask, lm_ids, L)
    ptr_pad = jnp.concatenate([m.lm_obs_ptr, jnp.zeros((1,), jnp.int32)])
    pos = ptr_pad[tgt] % O
    okf = jnp.concatenate(
        [m.lm_obs_kf, jnp.zeros((1, O), jnp.int32)]
    ).at[tgt, pos].set(
        jnp.where(mask, slot, -1).astype(jnp.int32))[:L]
    ofe = jnp.concatenate(
        [m.lm_obs_feat, jnp.zeros((1, O), jnp.int32)]
    ).at[tgt, pos].set(feat_idx.astype(jnp.int32))[:L]
    ptr = ptr_pad.at[tgt].add(jnp.where(mask, 1, 0))[:L]
    return m._replace(lm_obs_kf=okf, lm_obs_feat=ofe, lm_obs_ptr=ptr)


def rebuild_observer_index(m: MapState) -> MapState:
    """Recompute lm_obs_* from kf_lm (the source of truth) — for maps
    assembled by hand (tests, external builders, pre-r5 checkpoints).
    Host-side; oldest KF first so the ring keeps the newest observers."""
    import numpy as np

    kf_lm = np.asarray(m.kf_lm)
    kf_valid = np.asarray(m.kf_valid)
    kf_kp_valid = np.asarray(m.kf_kp_valid)
    kf_id = np.asarray(m.kf_id)
    L, O = m.lm_obs_kf.shape
    okf = np.full((L, O), -1, np.int32)
    ofe = np.zeros((L, O), np.int32)
    ptr = np.zeros(L, np.int32)
    for k in np.argsort(kf_id):
        if not kf_valid[k]:
            continue
        feats = np.nonzero((kf_lm[k] >= 0) & kf_kp_valid[k])[0]
        ls = kf_lm[k][feats]
        pos = ptr[ls] % O
        okf[ls, pos] = k
        ofe[ls, pos] = feats
        ptr[ls] += 1
    return m._replace(lm_obs_kf=jnp.asarray(okf),
                      lm_obs_feat=jnp.asarray(ofe),
                      lm_obs_ptr=jnp.asarray(ptr))


def observer_entries(m: MapState, lm_ids: jnp.ndarray,
                     valid: jnp.ndarray):
    """Resolve the observer lists of `lm_ids` ([N]) against the current
    bindings.  Returns (obs_kf [N,O] int32, obs_feat [N,O], ok [N,O] bool)
    where ok marks entries that still hold (self-invalidation check:
    kf alive and kf_lm[kf, feat] == l)."""
    L, O = m.lm_obs_kf.shape
    safe = jnp.where(valid, lm_ids, L)
    okf = jnp.concatenate(
        [m.lm_obs_kf, jnp.full((1, O), -1, jnp.int32)])[safe]   # [N,O]
    ofe = jnp.concatenate(
        [m.lm_obs_feat, jnp.zeros((1, O), jnp.int32)])[safe]
    kf_s = jnp.maximum(okf, 0)
    bound = m.kf_lm[kf_s, ofe]                                  # [N,O]
    ok = (okf >= 0) & m.kf_valid[kf_s] & (bound == lm_ids[:, None]) \
        & valid[:, None]
    return okf, ofe, ok


def kf_votes_of_ids(m: MapState, lm_ids: jnp.ndarray,
                    valid: jnp.ndarray) -> jnp.ndarray:
    """[K] int32: per-KF count of observed landmarks among `lm_ids` — the
    O(N*O) observer-list replacement for `kf_votes` when the landmark set
    is available as an id list (N <= a frame's keypoint budget).  Exact up
    to observer-ring overflow (max_obs_per_lm)."""
    K = m.kf_valid.shape[0]
    okf, _, ok = observer_entries(m, lm_ids, valid)
    votes = jnp.zeros((K + 1,), jnp.int32).at[
        jnp.where(ok, okf, K)
    ].add(1)[:K]
    return votes * m.kf_valid


def covis_row_fast(m: MapState, slot: jnp.ndarray) -> jnp.ndarray:
    """[K] int32 covisibility row of KF `slot` via the observer index:
    O(M*O) instead of the O(K*M) gather of `covis_row`.  Exact up to
    observer-ring overflow."""
    row = m.kf_lm[slot]
    ok = m.kf_kp_valid[slot] & (row >= 0)
    safe = jnp.maximum(row, 0)
    ok = ok & m.lm_valid[safe]
    votes = kf_votes_of_ids(m, safe, ok) * m.kf_valid[slot]
    return votes.at[slot].set(0)


def covis_rows_fast(m: MapState, slots: jnp.ndarray) -> jnp.ndarray:
    """[S,K] int32 covisibility rows via the observer index (vmapped)."""
    return jax.vmap(lambda s: covis_row_fast(m, s))(slots)


def landmark_mask_of_slots(m: MapState, slots: jnp.ndarray,
                           slot_valid: jnp.ndarray) -> jnp.ndarray:
    """[L] bool: landmarks observed by the given KF slots — gathers only
    those rows ([S,M]) instead of scattering the whole [K,M] table
    (landmark_mask_of_kfs)."""
    L = m.lm_pos.shape[0]
    rows = m.kf_lm[slots]                                        # [S,M]
    ok = m.kf_kp_valid[slots] & (rows >= 0) \
        & (slot_valid & m.kf_valid[slots])[:, None]
    flat = jnp.where(ok, rows, L).reshape(-1)
    return jnp.zeros((L + 1,), bool).at[flat].set(True)[:L] & m.lm_valid


def covis_row(m: MapState, slot: jnp.ndarray) -> jnp.ndarray:
    """[K] int32: one row of the covisibility graph (shared-landmark counts
    of KF `slot` vs every KF), O(K*M)."""
    L = m.lm_pos.shape[0]
    row = m.kf_lm[slot]
    ok = m.kf_kp_valid[slot] & (row >= 0)
    lmask = jnp.zeros((L + 1,), bool).at[
        jnp.where(ok, row, L)
    ].set(True)[:L] & m.lm_valid
    votes = kf_votes(m, lmask) * m.kf_valid[slot]
    return votes.at[slot].set(0)


def covis_rows(m: MapState, slots: jnp.ndarray) -> jnp.ndarray:
    """[S,K] int32 covisibility rows for a slot subset (vmapped covis_row)."""
    return jax.vmap(lambda s: covis_row(m, s))(slots)


def covisibility(m: MapState, chunk: int = 256) -> jnp.ndarray:
    """[K,K] int32 shared-landmark counts (keyframe.cpp:130-206's
    incrementally maintained graph as matmuls).

    At K <= chunk this is the single dense A A^T product.  Above, the
    product is blocked: incidence chunks [chunk, L] are (re)built on the
    fly per block pair, so peak memory is O(chunk*L + K^2) instead of
    O(K*L) — the 10 GB incidence cliff at 10k KFs never materializes.
    Only coarse-cadence consumers (pose-graph build, loop-candidate
    grouping, viewers, partitioners) need the full matrix."""
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]
    if K <= chunk:
        A = incidence(m).astype(jnp.bfloat16)
        W = jnp.dot(A, A.T, preferred_element_type=jnp.float32)
        W = W.astype(jnp.int32)
    else:
        n_c = -(-K // chunk)
        Kp = n_c * chunk
        ids = jnp.where(
            m.kf_kp_valid & m.kf_valid[:, None] & (m.kf_lm >= 0),
            m.kf_lm, L,
        )
        ids = jnp.concatenate(
            [ids, jnp.full((Kp - K, M), L, jnp.int32)], axis=0)
        lm_ok = jnp.concatenate(
            [m.lm_valid, jnp.zeros((1,), bool)]).astype(jnp.bfloat16)

        def build_A(ci):
            rows = jax.lax.dynamic_slice_in_dim(ids, ci * chunk, chunk, 0)
            A = jnp.zeros((chunk, L + 1), jnp.bfloat16).at[
                jnp.arange(chunk)[:, None], rows
            ].set(1.0)
            return A * lm_ok[None, :]

        def row_block(ci):
            Ai = build_A(ci)

            def col_block(cj):
                Aj = build_A(cj)
                return jnp.dot(Ai[:, :L], Aj[:, :L].T,
                               preferred_element_type=jnp.float32)

            blocks = jax.lax.map(col_block, jnp.arange(n_c))  # [n_c,c,c]
            return blocks.transpose(1, 0, 2).reshape(chunk, Kp)

        W = jax.lax.map(row_block, jnp.arange(n_c)).reshape(Kp, Kp)
        W = W[:K, :K].astype(jnp.int32)
    W = W * (1 - jnp.eye(K, dtype=jnp.int32))
    return W * (m.kf_valid[:, None] & m.kf_valid[None, :])


# ---------------------------------------------------------------- insert

@functools.partial(jax.jit, donate_argnames=("m",))
def insert_keyframe(
    m: MapState,
    frame: FrameData,
    lm_assoc: jnp.ndarray,   # [M] int32 landmark id per feature (-1 none)
    slot: jnp.ndarray,       # scalar int32 target row
    kf_id: jnp.ndarray,      # scalar int32 monotonic id
) -> MapState:
    """Write a frame into keyframe row `slot` (LocalMapping::InsertKeyFrame
    + ProcessNewKeyFrame association, localmapping.cpp:85-107)."""
    M = lm_assoc.shape[0]
    m = append_observations(
        m, jnp.maximum(lm_assoc, 0), jnp.arange(M, dtype=jnp.int32),
        slot, lm_assoc >= 0)
    return m._replace(
        kf_T_cw=m.kf_T_cw.at[slot].set(frame.T_cw),
        kf_valid=m.kf_valid.at[slot].set(True),
        kf_id=m.kf_id.at[slot].set(kf_id),
        kf_xy=m.kf_xy.at[slot].set(frame.xy_und),
        kf_ur=m.kf_ur.at[slot].set(frame.ur),
        kf_z=m.kf_z.at[slot].set(frame.depth),
        kf_desc=m.kf_desc.at[slot].set(frame.feat.desc),
        kf_octave=m.kf_octave.at[slot].set(frame.feat.octave),
        kf_kp_valid=m.kf_kp_valid.at[slot].set(frame.feat.valid),
        kf_lm=m.kf_lm.at[slot].set(lm_assoc),
    )


@functools.partial(
    jax.jit, static_argnames=("max_new", "th_depth"), donate_argnames=("m",)
)
def create_landmarks(
    m: MapState,
    frame: FrameData,
    lm_assoc: jnp.ndarray,   # [M] current landmark binding of the frame
    slot: jnp.ndarray,       # KF row the frame was inserted into
    kf_id: jnp.ndarray,
    max_new: int,
    th_depth: float,
):
    """Spawn landmarks for up to `max_new` closest unbound keypoints with
    valid depth below th_depth (tracking.cpp:488-535: sorted by depth,
    <=100 close points; at init all valid-depth points).  Slots are
    allocated from FREE rows of the landmark table (rows vacated by
    culling/fusion are reused — no monotonic-counter capacity leak).

    Returns (map, new_assoc [M], n_created scalar)."""
    M = lm_assoc.shape[0]
    L = m.lm_pos.shape[0]
    eligible = (
        frame.feat.valid & frame.has_depth & (lm_assoc < 0)
        & (frame.depth < th_depth)
    )
    depth_key = jnp.where(eligible, frame.depth, jnp.inf)
    order = jnp.argsort(depth_key)                    # closest first
    take = jnp.arange(M) < jnp.minimum(
        jnp.sum(eligible.astype(jnp.int32)), max_new
    )
    chosen = order  # feature index by rank
    is_new = take  # ranks actually used

    # allocation: rank r -> r-th free landmark row, in stable index order
    # (nonzero-with-size; a full argsort over the landmark table costs
    # ~5 ms at the 8k-KF capacity, r5)
    n_free = L - jnp.sum(m.lm_valid.astype(jnp.int32))
    (new_ids,) = jnp.nonzero(~m.lm_valid, size=M, fill_value=L - 1)
    new_ids = new_ids.astype(jnp.int32)
    in_cap = jnp.arange(M) < n_free
    is_new = is_new & in_cap
    n_created = jnp.sum(is_new.astype(jnp.int32))

    pts_w = transform_points(T_inv(frame.T_cw), frame.p3d)   # [M,3]
    sel_pts = pts_w[chosen]
    sel_desc = frame.feat.desc[chosen]

    tgt = jnp.where(is_new, new_ids, L)               # L = scratch row
    lm_pos = jnp.concatenate([m.lm_pos, jnp.zeros((1, 3))]) \
        .at[tgt].set(sel_pts)[:L]
    lm_desc = jnp.concatenate([m.lm_desc, jnp.zeros((1, 8), jnp.uint32)]) \
        .at[tgt].set(sel_desc)[:L]
    lm_valid = jnp.concatenate([m.lm_valid, jnp.zeros((1,), bool)]) \
        .at[tgt].set(True)[:L]
    lm_first = jnp.concatenate([m.lm_first_kf, jnp.zeros((1,), jnp.int32)]) \
        .at[tgt].set(kf_id)[:L]
    # reused rows must not inherit the previous occupant's statistics
    lm_visible = jnp.concatenate([m.lm_visible, jnp.zeros((1,), jnp.int32)]) \
        .at[tgt].set(0)[:L]
    lm_found = jnp.concatenate([m.lm_found, jnp.zeros((1,), jnp.int32)]) \
        .at[tgt].set(0)[:L]
    # ... nor its observer list
    O = m.lm_obs_kf.shape[1]
    lm_obs_kf = jnp.concatenate(
        [m.lm_obs_kf, jnp.zeros((1, O), jnp.int32)]
    ).at[tgt].set(-1)[:L]
    lm_obs_ptr = jnp.concatenate(
        [m.lm_obs_ptr, jnp.zeros((1,), jnp.int32)]
    ).at[tgt].set(0)[:L]

    # bind features: feature chosen[r] -> new_ids[r]
    feat_tgt = jnp.where(is_new, chosen, M)
    assoc = jnp.concatenate([lm_assoc, jnp.full((1,), -1, jnp.int32)]) \
        .at[feat_tgt].set(jnp.where(is_new, new_ids, -1))[:M]

    m = m._replace(
        lm_pos=lm_pos, lm_desc=lm_desc, lm_valid=lm_valid,
        lm_first_kf=lm_first, lm_visible=lm_visible, lm_found=lm_found,
        lm_obs_kf=lm_obs_kf, lm_obs_ptr=lm_obs_ptr,
        kf_lm=m.kf_lm.at[slot].set(assoc),
    )
    # record the new bindings in the observer index (the carried-assoc
    # bindings were recorded by insert_keyframe)
    m = append_observations(
        m, jnp.where(is_new, new_ids, 0), chosen.astype(jnp.int32),
        slot, is_new)
    return m, assoc, n_created


# ---------------------------------------------------------------- culling

@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def landmark_culling(m: MapState, current_kf_id: jnp.ndarray,
                     cfg: SystemConfig) -> MapState:
    """Reference rule (localmapping.cpp:110-134): over the RECENTLY ADDED
    landmarks (the reference's mlpRecentAddedMapPoints — it never culls
    old, established landmarks here), kill those with found/visible ratio
    < 0.25, or with nObs <= `cull_min_obs` more than 2 KFs after creation
    — nObs counts depth observations TWICE (landmark.cpp:69-80), so one
    stereo observation dies and two survive, exactly as in the reference.

    r5: the candidate set is compacted (landmarks created within the last
    4 KF ids, cap 4096) and obs counts / unbinds walk the observer
    reverse index — O(cap * max_obs) instead of two [K,M]-wide passes.
    Pre-r5 this function also applied the found-ratio rule to ALL
    landmarks (stricter than the reference); that deviation is gone."""
    L = m.lm_pos.shape[0]
    from aslam.ops.matching import compact_candidates

    recent = (
        m.lm_valid & (m.lm_first_kf >= 0)
        & ((current_kf_id - m.lm_first_kf) <= 4)
    )
    cap = min(4096, L)
    cidx, cvalid, _ = compact_candidates(recent, cap)
    okf, ofe, ok = observer_entries(m, cidx, cvalid)        # [cap,O]
    w = jnp.where(m.kf_z[jnp.maximum(okf, 0), ofe] > 0, 2, 1)
    nobs = jnp.sum(jnp.where(ok, w, 0), axis=1)
    found_ratio = m.lm_found[cidx] / jnp.maximum(m.lm_visible[cidx], 1)
    seen = m.lm_visible[cidx] > 0
    bad_ratio = seen & (found_ratio < cfg.map.cull_found_ratio)
    mature = (current_kf_id - m.lm_first_kf[cidx]) >= 2
    bad_obs = mature & (nobs <= cfg.map.cull_min_obs)
    bad = cvalid & (bad_ratio | bad_obs)

    lm_valid = jnp.concatenate([m.lm_valid, jnp.zeros((1,), bool)]) \
        .at[jnp.where(bad, cidx, L)].set(False)[:L]
    # unbind the culled landmarks' observations via their observer entries
    K, M = m.kf_lm.shape
    kill = ok & bad[:, None]
    t_kf = jnp.where(kill, okf, K)
    t_fe = jnp.where(kill, ofe, 0)
    kf_lm = jnp.concatenate(
        [m.kf_lm, jnp.zeros((1, M), jnp.int32)]
    ).at[t_kf, t_fe].set(-1)[:K]
    return m._replace(lm_valid=lm_valid, kf_lm=kf_lm)


class CullInfo(NamedTuple):
    """Parent-chain record of a culled keyframe, for trajectory recovery.

    The reference stores `mTcp` (pose relative to the spanning-tree parent)
    when a KF is erased (keyframe.cpp:506) so `SaveTrajectory` can walk
    dead reference KFs up to a surviving ancestor (tracking.cpp:564-567).
    Here the parent is the surviving KF most covisible with the victim
    (the spanning-tree re-parenting rule, keyframe.cpp:429-512, picks the
    top covisible candidate)."""

    culled: jnp.ndarray        # scalar bool: did a cull happen
    kf_id: jnp.ndarray         # scalar int32 victim kf_id (-1 if none)
    parent_kf_id: jnp.ndarray  # scalar int32 parent kf_id (-1 if none)
    T_cp: jnp.ndarray          # [4,4] victim pose relative to parent


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def keyframe_culling(m: MapState, current_slot: jnp.ndarray,
                     cfg: SystemConfig):
    """Reference rule (localmapping.cpp:196-238): a KF is redundant when
    >95% of its close landmarks are observed >= 3 times elsewhere.

    Returns (map, CullInfo) — the CullInfo is the victim's parent-chain
    record the host appends to its culled-KF registry.

    r5: only the current KF's COVISIBLE neighbors are scored — exactly the
    reference's scan set (localmapping.cpp:198 iterates
    GetVectorCovisibleKeyFrames of the current KF) — and observation
    counts come from the observer reverse index, so per-call work is
    O(N*M*max_obs) and independent of the map's keyframe capacity (the
    [K,M] histogram cost 34 ms at the 8k-KF contract).  Ring overflow
    undercounts, which only makes culling MORE conservative."""
    L = m.lm_pos.shape[0]
    K = m.kf_valid.shape[0]
    N = min(cfg.map.kf_cull_candidates, K)
    w_row = covis_row_fast(m, current_slot)
    # never cull the first or the current KF
    cand_rank = jnp.where(m.kf_valid, w_row, -1) \
        .at[0].set(-1).at[current_slot].set(-1)
    cand_vals, cand_idx = jax.lax.top_k(cand_rank, N)
    cand_ok = cand_vals > 0

    rows = m.kf_lm[cand_idx]                          # [N,M]
    kp_ok = m.kf_kp_valid[cand_idx]
    z = m.kf_z[cand_idx]
    ids = jnp.where(kp_ok, rows, -1)
    has_lm = ids >= 0
    close = has_lm & (z > 0) & (z < cfg.camera.th_depth)
    M_feat = rows.shape[1]
    _, _, ent_ok = observer_entries(
        m, jnp.maximum(ids, 0).reshape(-1), (ids >= 0).reshape(-1))
    lm_obs = jnp.sum(ent_ok, axis=1).reshape(N, M_feat)
    redundant_obs = close & (lm_obs >= 4)  # seen >=3 times elsewhere
    n_close = jnp.sum(close, axis=1)
    n_red = jnp.sum(redundant_obs, axis=1)
    redundant_cand = (
        cand_ok
        & (n_close > 0)
        & (n_red > cfg.map.kf_cull_redundancy * n_close)
    )
    # cull at most one KF per call (mirrors incremental behavior, keeps
    # the map stable)
    first = cand_idx[jnp.argmax(redundant_cand)]
    do = jnp.any(redundant_cand)

    # parent = surviving KF most covisible with the victim (computed while
    # the victim is still valid so its covisibility row exists)
    w_row = covis_row_fast(m, first)
    parent_rank = jnp.where(m.kf_valid, w_row, -1).at[first].set(-1)
    parent = jnp.argmax(parent_rank)
    T_cp = m.kf_T_cw[first] @ T_inv(m.kf_T_cw[parent])
    info = CullInfo(
        culled=do,
        kf_id=jnp.where(do, m.kf_id[first], -1),
        parent_kf_id=jnp.where(do, m.kf_id[parent], -1),
        T_cp=T_cp,
    )

    kf_valid = m.kf_valid.at[first].set(
        jnp.where(do, False, m.kf_valid[first])
    )
    kf_lm = m.kf_lm.at[first].set(
        jnp.where(do, jnp.full_like(m.kf_lm[first], -1), m.kf_lm[first])
    )
    return m._replace(kf_valid=kf_valid, kf_lm=kf_lm), info


# ---------------------------------------------------------------- positions

@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def refresh_landmark_positions(m: MapState, cfg: SystemConfig) -> MapState:
    """Closed-form multi-view landmark position refresh.

    Each landmark's position becomes the information-weighted mean of its
    observing keyframes' backprojections at their CURRENT poses, with
    weights 1/sigma_z^2 from the Khoshelham depth model sigma_z = 0.01 z^2
    (the reference's own error model, ransac.cpp:423-431) and a 3-sigma
    trimmed second pass so a single bad observation cannot drag the
    estimate.  Single-view depth noise (4-9 cm at 2-3 m) is the dominant
    landmark position error and anchors the whole tracking chain; n
    agreeing observations cut it ~sqrt(n).  The reference only gets this
    effect implicitly (and locally) through g2o BA; as a pure segment
    reduction over the [K,M] observation table it costs one pass per KF
    insertion.  Landmarks with no depth-valid observation keep
    their positions."""
    cam = cfg.camera
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]

    obs_ok = (
        m.kf_kp_valid & m.kf_valid[:, None] & (m.kf_lm >= 0) & (m.kf_z > 0)
    )
    p_c = camera.unproject(cam, m.kf_xy, m.kf_z)          # [K,M,3]
    T_wc = jax.vmap(T_inv)(m.kf_T_cw)                      # [K,4,4]
    p_w = jnp.einsum("kij,kmj->kmi", T_wc[:, :3, :3], p_c) \
        + T_wc[:, None, :3, 3]                             # [K,M,3]

    sigma = 0.01 * m.kf_z * m.kf_z + 1e-3                  # [K,M]
    w = jnp.where(obs_ok, 1.0 / (sigma * sigma), 0.0)
    idx = jnp.where(obs_ok, m.kf_lm, L).reshape(-1)

    def weighted_mean(wv):
        flat_w = wv.reshape(-1)
        sw = jnp.zeros((L + 1,), w.dtype).at[idx].add(flat_w)[:L]
        sp = jnp.zeros((L + 1, 3), w.dtype).at[idx].add(
            flat_w[:, None] * p_w.reshape(-1, 3)
        )[:L]
        return sp / jnp.maximum(sw, 1e-12)[:, None], sw

    mean1, sw1 = weighted_mean(w)
    # trimmed second pass: drop observations beyond the shared 3-sigma
    # Khoshelham gate from the first-pass mean (depth edges, mismatched
    # fuse bindings)
    safe_lm = jnp.clip(m.kf_lm, 0, L - 1)
    dist = jnp.linalg.norm(p_w - mean1[safe_lm], axis=-1)  # [K,M]
    keep = dist <= camera.khoshelham_gate(m.kf_z)
    mean2, sw2 = weighted_mean(jnp.where(keep, w, 0.0))

    has2 = sw2 > 0
    new_pos = jnp.where(has2[:, None], mean2, mean1)
    has_any = (sw1 > 0) & m.lm_valid
    return m._replace(
        lm_pos=jnp.where(has_any[:, None], new_pos, m.lm_pos)
    )


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("m",))
def refresh_landmark_positions_ids(m: MapState, lm_ids: jnp.ndarray,
                                   valid: jnp.ndarray,
                                   cfg: SystemConfig) -> MapState:
    """`refresh_landmark_positions` for an ID LIST (the landmarks a new
    keyframe touches) via the observer reverse index: backprojections of
    each listed landmark's ring entries, information-weighted mean with
    the 3-sigma trimmed second pass — O(N * max_obs) instead of two
    [K,M]-wide scatter passes (r5; at the 8k-KF contract the global pass
    costs ~70 ms/KF).  Landmarks outside the list keep their positions —
    which is also what the global pass does for landmarks with no new
    observation, since their weighted mean is unchanged."""
    cam = cfg.camera
    L = m.lm_pos.shape[0]
    okf, ofe, ok = observer_entries(m, lm_ids, valid)      # [N,O]
    kf_s = jnp.maximum(okf, 0)
    xy = m.kf_xy[kf_s, ofe]                                # [N,O,2]
    z = m.kf_z[kf_s, ofe]                                  # [N,O]
    ok = ok & (z > 0)
    p_c = camera.unproject(cam, xy, z)                     # [N,O,3]
    T_wc = jax.vmap(T_inv)(m.kf_T_cw)[kf_s]                # [N,O,4,4]
    p_w = jnp.einsum("noij,noj->noi", T_wc[..., :3, :3], p_c) \
        + T_wc[..., :3, 3]
    sigma = 0.01 * z * z + 1e-3
    w = jnp.where(ok, 1.0 / (sigma * sigma), 0.0)

    def wmean(wv):
        sw = jnp.sum(wv, axis=1)
        sp = jnp.einsum("no,noi->ni", wv, p_w)
        return sp / jnp.maximum(sw, 1e-12)[:, None], sw

    mean1, sw1 = wmean(w)
    dist = jnp.linalg.norm(p_w - mean1[:, None, :], axis=-1)
    keep = dist <= camera.khoshelham_gate(z)
    mean2, sw2 = wmean(jnp.where(keep, w, 0.0))
    new_pos = jnp.where((sw2 > 0)[:, None], mean2, mean1)
    has = (sw1 > 0) & valid & m.lm_valid[jnp.maximum(lm_ids, 0)]
    lm_pos = jnp.concatenate([m.lm_pos, jnp.zeros((1, 3))]) \
        .at[jnp.where(has, lm_ids, L)].set(new_pos)[:L]
    return m._replace(lm_pos=lm_pos)


# ---------------------------------------------------------------- descriptors

@functools.partial(jax.jit, donate_argnames=("m",))
def refresh_landmark_descriptors_ids(m: MapState, lm_ids: jnp.ndarray,
                                     valid: jnp.ndarray) -> MapState:
    """Distinctive-descriptor (medoid) refresh for an ID LIST of landmarks
    (e.g. the ones a new keyframe touches) via the observer reverse index:
    O(N * max_obs_per_lm) — replaces the full-table sort-and-scatter of
    `refresh_landmark_descriptors` on the per-keyframe hot path
    (landmark.cpp:219-273 semantics, r5)."""
    L = m.lm_pos.shape[0]
    okf, ofe, ok = observer_entries(m, lm_ids, valid)      # [N,O]
    desc = m.kf_desc[jnp.maximum(okf, 0), ofe]             # [N,O,8]

    def medoid(desc_set, cnt, fallback):
        d = hamming.distance_matrix_popcount(desc_set, desc_set)
        d = jnp.where(cnt[None, :], d, 0.0)
        total = jnp.where(cnt, jnp.sum(d, axis=1), jnp.inf)
        best = jnp.argmin(total)
        return jnp.where(jnp.any(cnt), desc_set[best], fallback)

    fallback = m.lm_desc[jnp.maximum(lm_ids, 0)]
    new_desc = jax.vmap(medoid)(desc, ok, fallback)
    w_ok = valid & m.lm_valid[jnp.maximum(lm_ids, 0)]
    tgt = jnp.where(w_ok, lm_ids, L)
    lm_desc = jnp.concatenate(
        [m.lm_desc, jnp.zeros((1, 8), jnp.uint32)]
    ).at[tgt].set(new_desc)[:L]
    return m._replace(lm_desc=lm_desc)


@functools.partial(jax.jit, static_argnames=("max_obs",), donate_argnames=("m",))
def refresh_landmark_descriptors(m: MapState, lm_mask: jnp.ndarray,
                                 max_obs: int = 8) -> MapState:
    """Distinctive descriptor = medoid (min total Hamming distance) over up
    to max_obs observations (landmark.cpp:219-273 computes the min-median;
    the medoid is the same estimator family, batched).

    lm_mask selects which landmarks to refresh (e.g. those touched by the
    newest keyframe)."""
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]

    # gather up to max_obs observing (kf, feat) pairs per landmark by
    # scatter with per-landmark cursors emulated via priority trick:
    # use segment-sort: flatten edges, sort by lm id, take first max_obs.
    ids = jnp.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_lm, -1)
    flat_ids = jnp.where(ids >= 0, ids, L).reshape(-1)
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    # rank within landmark group
    idx = jnp.arange(sorted_ids.shape[0])
    group_start = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = idx - group_start
    use = (sorted_ids < L) & (rank < max_obs)
    # scatter descriptors into [L, max_obs, 8]
    desc_flat = m.kf_desc.reshape(-1, 8)[order]
    tgt_l = jnp.where(use, sorted_ids, L)
    tgt_r = jnp.where(use, rank, 0)
    obs_desc = jnp.zeros((L + 1, max_obs, 8), jnp.uint32).at[tgt_l, tgt_r].set(
        desc_flat
    )[:L]
    obs_cnt = jnp.zeros((L + 1, max_obs), bool).at[tgt_l, tgt_r].set(use)[:L]

    # pairwise Hamming per landmark, medoid selection
    def medoid(desc_set, cnt, fallback):
        d = hamming.distance_matrix_popcount(desc_set, desc_set)
        d = jnp.where(cnt[None, :], d, 0.0)
        total = jnp.where(cnt, jnp.sum(d, axis=1), jnp.inf)
        best = jnp.argmin(total)
        return jnp.where(jnp.any(cnt), desc_set[best], fallback)

    new_desc = jax.vmap(medoid)(obs_desc, obs_cnt, m.lm_desc)
    lm_desc = jnp.where((lm_mask & m.lm_valid)[:, None], new_desc, m.lm_desc)
    return m._replace(lm_desc=lm_desc)
