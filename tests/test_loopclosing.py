"""Loop closing end-to-end on a hand-built drifted map.

A corridor of keyframes accumulates drift; the last KF revisits the first
location and observes the same scene points with the same descriptors.  The
loop closer must: train a vocabulary, find the first KF as a candidate
(skipping covisible/recent KFs), verify it geometrically with RANSAC, and
pull the drifted trajectory back via pose-graph optimization + landmark
re-anchoring."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import mapstate as ms
from aslam.models.loopclosing import LoopClosing
from aslam.utils import camera, synthetic
from aslam.utils.se3 import T_inv


def build_looped_map(rng, n_kfs=20, drift_per_step=0.008):
    """KFs 0..n-1 along +x and back; KF n-1 at the same true pose as KF 0.
    Estimated poses accumulate drift.  Each KF observes the points in front
    of its TRUE pose; the same world point always carries the same
    descriptor."""
    cfg = small_config()
    cam = cfg.camera
    M = cfg.extractor.max_keypoints
    L = cfg.map.max_landmarks

    # world points scattered along the corridor (z forward from origin)
    n_pts = 600
    pts = np.stack([
        rng.uniform(-1.0, 3.0, n_pts),
        rng.uniform(-1.0, 1.0, n_pts),
        rng.uniform(1.5, 3.5, n_pts),
    ], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)

    # true poses: out along +x then back; last pose == first pose
    xs = np.concatenate([
        np.linspace(0, 2.0, n_kfs // 2),
        np.linspace(2.0, 0.0, n_kfs - n_kfs // 2),
    ])
    xs[-1] = 0.0
    T_true = []
    for x in xs:
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -x   # camera at world x: T_cw translation = -x
        T_true.append(T)
    T_true = np.stack(T_true)

    # drifted estimates (drift grows with index; KF0 exact)
    T_est = T_true.copy()
    acc = np.zeros(3, np.float32)
    for i in range(1, n_kfs):
        acc += rng.normal(0, drift_per_step, 3).astype(np.float32)
        T_est[i, :3, 3] += acc
    drift_final = float(np.linalg.norm(T_est[-1, :3, 3] - T_true[-1, :3, 3]))

    m = ms.init_map(cfg)
    next_lm = 0
    lm_of_point = np.full(n_pts, -1, np.int64)
    lm_created_kf = np.full(n_pts, -(10**6), np.int64)
    for k in range(n_kfs):
        Tt = T_true[k]
        pc = pts @ Tt[:3, :3].T + Tt[:3, 3]
        uv, z = camera.project(cam, jnp.asarray(pc))
        uv, z = np.asarray(uv), np.asarray(z)
        vis = (z > 0.2) & (uv[:, 0] > 5) & (uv[:, 0] < cam.width - 5) \
            & (uv[:, 1] > 5) & (uv[:, 1] < cam.height - 5) \
            & (np.abs(pts[:, 0] - xs[k]) < 0.8)  # narrow effective FOV so
        # points leave view mid-run and association breaks before revisit
        sel = np.nonzero(vis)[0][:M]
        n_f = len(sel)

        kf_xy = np.zeros((M, 2), np.float32)
        kf_z = np.zeros(M, np.float32)
        kf_desc = np.zeros((M, 8), np.uint32)
        kp_valid = np.zeros(M, bool)
        assoc = np.full(M, -1, np.int32)
        kf_xy[:n_f] = uv[sel]
        kf_z[:n_f] = z[sel]
        kf_desc[:n_f] = descs[sel]
        kp_valid[:n_f] = True
        for f, p_i in enumerate(sel):
            # drift breaks long-range data association: a point unseen for
            # >3 KFs gets a fresh duplicate landmark (exactly what happens
            # before a loop closure in the real pipeline)
            if lm_of_point[p_i] < 0 or k - lm_created_kf[p_i] > 3:
                lm_of_point[p_i] = next_lm
                m = m._replace(
                    lm_pos=m.lm_pos.at[next_lm].set(jnp.asarray(pts[p_i])),
                    lm_desc=m.lm_desc.at[next_lm].set(jnp.asarray(descs[p_i])),
                    lm_valid=m.lm_valid.at[next_lm].set(True),
                    lm_first_kf=m.lm_first_kf.at[next_lm].set(k),
                )
                next_lm += 1
            lm_created_kf[p_i] = k  # continuous visibility keeps the lm
            assoc[f] = lm_of_point[p_i]

        ur = np.where(kf_z > 0, kf_xy[:, 0] - cam.bf / np.maximum(kf_z, 1e-6), -1.0)
        m = m._replace(
            kf_T_cw=m.kf_T_cw.at[k].set(jnp.asarray(T_est[k])),
            kf_valid=m.kf_valid.at[k].set(True),
            kf_id=m.kf_id.at[k].set(k),
            kf_xy=m.kf_xy.at[k].set(jnp.asarray(kf_xy)),
            kf_ur=m.kf_ur.at[k].set(jnp.asarray(ur.astype(np.float32))),
            kf_z=m.kf_z.at[k].set(jnp.asarray(kf_z)),
            kf_desc=m.kf_desc.at[k].set(jnp.asarray(kf_desc)),
            kf_kp_valid=m.kf_kp_valid.at[k].set(jnp.asarray(kp_valid)),
            kf_lm=m.kf_lm.at[k].set(jnp.asarray(assoc)),
        )
    m = ms.rebuild_observer_index(m)
    return cfg, m, T_true, T_est, drift_final, n_kfs


def test_loop_detected_and_corrected(rng):
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    assert drift > 0.02, "test needs visible drift"

    lc = LoopClosing(cfg, train_after_kfs=4)
    # feed keyframes in order; the return leg re-detects the outbound KFs
    # over >= consistency_th consecutive keyframes, then a loop closes
    for k in range(n_kfs):
        m = lc.process_keyframe(m, k, k)

    assert len(lc.loops) >= 1, "no loop detected"
    q, c = lc.loops[-1]
    # the loop must connect a return-path KF to an outbound KF that was at
    # a nearby true position (the camera retraces its path)
    assert q >= n_kfs // 2 and c < n_kfs // 2, (q, c)
    # camera x = -T_cw translation x; pair must share a view band
    xs_err = abs(float(-T_true[q][0, 3]) - float(-T_true[c][0, 3]))
    assert xs_err < 1.6, f"loop pair {q}<->{c} views don't overlap"

    # drift at the loop-closing KF reduced vs its pre-correction estimate
    err_before = float(np.linalg.norm(T_est[q][:3, 3] - T_true[q][:3, 3]))
    err_after = float(np.linalg.norm(
        np.asarray(m.kf_T_cw)[q][:3, 3] - T_true[q][:3, 3]
    ))
    assert err_after < err_before * 0.8, (
        f"drift {err_before:.4f} -> {err_after:.4f}"
    )


def test_no_loop_without_revisit(rng):
    """A straight-out corridor (no revisit) must not close loops: every
    candidate is blocked by the gap/covisibility/geometry gates."""
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    lc = LoopClosing(cfg, train_after_kfs=4)
    # only feed the outbound half (no revisit)
    for k in range(n_kfs // 2):
        m = lc.process_keyframe(m, k, k)
    assert len(lc.loops) == 0


def test_vocabulary_refresh_on_map_growth(rng):
    """Incremental vocabulary refresh: when the map outgrows the training
    set (refresh_factor x), the vocabulary retrains and the database is
    rebuilt under the new word space — and loops still close."""
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    lc = LoopClosing(cfg, train_after_kfs=4, refresh_factor=2.0)
    K = m.kf_valid.shape[0]
    vocabs = []
    for k in range(n_kfs):
        # growing view of the map: KFs arrive one at a time
        m_k = m._replace(kf_valid=m.kf_valid & (jnp.arange(K) <= k))
        lc.process_keyframe(m_k, k, k)
        if lc.vocab is not None and (not vocabs or vocabs[-1] is not lc.vocab):
            vocabs.append(lc.vocab)
    # trained at 4 KFs, refreshed at >= 8 (factor 2)
    assert len(vocabs) >= 2, "no refresh happened"
    assert lc.trained_on_kfs >= 8
    # database rebuilt consistently: every valid KF queryable
    assert np.asarray(lc.db.kf_in_db)[:n_kfs].all()
    # loop closing still works across the refresh
    assert len(lc.loops) >= 1


def test_aliased_place_rejected_true_loop_closes(rng):
    """Perceptual aliasing: a second 'room' with IDENTICAL descriptors but
    different geometry (shuffled point layout) must NOT close a loop — BoW
    detection fires consistently, but geometric verification fails.  The
    consistency gate + top-N verification design (VERDICT missing #6)."""
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    # rebuild the return-leg KFs' descriptors so they alias the outbound
    # leg's words (same descriptor multiset) while their keypoint geometry
    # stays the true revisit geometry — EXCEPT we shuffle which descriptor
    # sits on which keypoint, destroying rigid correspondence
    kf_desc = np.asarray(m.kf_desc).copy()
    for k in range(n_kfs // 2, n_kfs):
        valid = np.asarray(m.kf_kp_valid[k])
        idx = np.nonzero(valid)[0]
        perm = rng.permutation(len(idx))
        kf_desc[k][idx] = kf_desc[k][idx][perm]
    m = m._replace(kf_desc=jnp.asarray(kf_desc))

    lc = LoopClosing(cfg, train_after_kfs=4)
    for k in range(n_kfs):
        m = lc.process_keyframe(m, k, k)
    assert len(lc.loops) == 0, f"false loop closed: {lc.loops}"


def test_transient_alias_blocked_by_consistency_gate(rng):
    """A one-off aliased detection (a single KF that resembles an old
    place) must be swallowed by the temporal-consistency gate before any
    geometric verification runs."""
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    lc = LoopClosing(cfg, train_after_kfs=4)
    verified = []
    import aslam.models.loopclosing as lcm

    orig_verify = lcm.verify_loop

    def spy(*a, **kw):
        verified.append(1)
        return orig_verify(*a, **kw)

    lcm.verify_loop = spy
    try:
        # outbound leg + exactly TWO return KFs: detections can streak at
        # most twice, under consistency_th=3 -> nothing may be verified
        assert cfg.loop.consistency_th == 3
        for k in list(range(n_kfs // 2 + 2)):
            m = lc.process_keyframe(m, k, k)
        # feed the first two KFs of the return leg only
        for k in (n_kfs - 2, n_kfs - 1):
            m = lc.process_keyframe(m, k, k)
    finally:
        lcm.verify_loop = orig_verify
    assert len(lc.loops) == 0
    assert not verified, "gate leaked a transient detection to verification"


def test_no_refresh_for_shipped_vocab(rng, tmp_path):
    """A vocabulary loaded from disk (shipped artifact) is never retrained."""
    from aslam.ops import bow

    cfg, m, *_ = build_looped_map(rng)
    descs = np.random.default_rng(0).integers(
        0, 2**32, (500, 8), dtype=np.uint32)
    v = bow.train_vocabulary(descs, branching=cfg.loop.vocab_branching,
                             depth=cfg.loop.vocab_depth)
    bow.save_vocabulary(str(tmp_path / "voc.npz"), v)
    lc = LoopClosing(cfg, vocab_path=str(tmp_path / "voc.npz"),
                     refresh_factor=2.0)
    v0 = lc.vocab
    for k in range(10):
        m = lc.process_keyframe(m, k, k)
    assert lc.vocab is v0
