"""Round-3 robustness additions:

1. A verified-but-slightly-wrong loop transform (5 cm / 2 deg bias at a
   marginal inlier grade) must be absorbed by the inlier-weighted pose
   graph + post-loop GBA without corrupting the map (VERDICT r2 weak #6).
2. WEAK-regime local-map expansion: with sparse associations entering
   mapped-but-unvoted territory, the one-hop covisibility expansion
   (tracking.cpp:308-346) must feed the projection search more landmarks
   than the vote alone (VERDICT r2 missing #3).
"""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import mapstate as ms
from aslam.models.extractor import Features
from aslam.models.frame import FrameData
from aslam.models.loopclosing import build_pose_graph, correct_map
from aslam.models.tracking import track_local_map
from aslam.ops import pose_graph
from aslam.utils import camera
from tests.test_loopclosing import build_looped_map


def test_biased_loop_edge_absorbed(rng):
    """Inject a verified-but-biased loop transform: the inlier-weighted
    graph must average it against the odometry chain — no KF may end up
    worse than the worst pre-correction drift, and the loop-end error must
    still shrink."""
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    q, c = n_kfs - 1, 0

    # true relative transform + 5 cm / 2 deg bias
    T_qc_true = T_true[q] @ np.linalg.inv(T_true[c])
    th = np.deg2rad(2.0)
    Rz = np.array([
        [np.cos(th), -np.sin(th), 0],
        [np.sin(th), np.cos(th), 0],
        [0, 0, 1],
    ])
    bias = np.eye(4)
    bias[:3, :3] = Rz
    bias[:3, 3] = [0.05, 0.0, 0.0]
    T_qc_biased = bias @ T_qc_true

    pg = build_pose_graph(
        m, jnp.int32(q), jnp.int32(c), jnp.asarray(T_qc_biased), cfg,
        loop_inliers=jnp.int32(20),   # marginal verification grade
    )
    pg = pose_graph.optimize(pg, iters=cfg.loop.pose_graph_iters)
    m2 = correct_map(m, pg.T)

    err_before = np.linalg.norm(
        T_est[:n_kfs, :3, 3] - T_true[:n_kfs, :3, 3], axis=1)
    err_after = np.linalg.norm(
        np.asarray(m2.kf_T_cw)[:n_kfs, :3, 3] - T_true[:n_kfs, :3, 3],
        axis=1)
    # the biased edge is one voice among covisibility+temporal edges: the
    # worst-case error may not exceed the pre-correction worst drift plus
    # a fraction of the injected bias
    assert err_after.max() < err_before.max() + 0.03, (
        err_before.max(), err_after.max())
    # and the loop end must still improve
    assert err_after[q] < err_before[q]


def test_biased_loop_weight_vs_hardcoded(rng):
    """The inlier-weighted loop edge (20 inliers -> ~1.3x a covisibility
    edge) must distort the rest of the chain LESS than the old hardcoded
    10x weight under the same biased measurement."""
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    # this test isolates the LOOP edge's weighting against UNIFORM
    # covisibility edges (the r3 scenario it was written for); r5 flipped
    # covis_weighted_edges on by default (docs/LOOP_ABLATION.md), which
    # changes the balance this comparison assumes — pin it off here
    import dataclasses as _dc

    cfg = cfg.replace(loop=_dc.replace(cfg.loop,
                                       covis_weighted_edges=False))
    q, c = n_kfs - 1, 0
    T_qc = T_true[q] @ np.linalg.inv(T_true[c])
    bias = np.eye(4)
    bias[:3, 3] = [0.08, 0.0, 0.0]
    T_qc = bias @ T_qc

    errs = {}
    for name, inl in [("weighted", jnp.int32(20)), ("hard", None)]:
        pg = build_pose_graph(
            m, jnp.int32(q), jnp.int32(c), jnp.asarray(T_qc), cfg,
            loop_inliers=inl,
        )
        pg = pose_graph.optimize(pg, iters=cfg.loop.pose_graph_iters)
        m2 = correct_map(m, pg.T)
        err = np.linalg.norm(
            np.asarray(m2.kf_T_cw)[:n_kfs, :3, 3] - T_true[:n_kfs, :3, 3],
            axis=1)
        # error away from the loop ends (the chain the wrong edge shears)
        errs[name] = float(err[1:-1].mean())
    assert errs["weighted"] <= errs["hard"] + 1e-6, errs


def test_post_loop_gba_improves_on_pose_graph(rng):
    """The pose graph leaves a seam at the loop ends (it moves only
    poses); the staged GBA-after-loop intent of the reference
    (globalbundleadjustment.cpp:154-190) is wired live in r3 — a bounded
    full-map BA after correct_map must reduce mean KF pose error vs
    pose-graph-only on a drifted loop."""
    import dataclasses

    from aslam.models.loopclosing import LoopClosing

    results = {}
    for iters in (0, 8):
        rng2 = np.random.default_rng(7)        # identical map both arms
        cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng2)
        cfg = cfg.replace(
            loop=dataclasses.replace(cfg.loop, post_gba_iters=iters))
        lc = LoopClosing(cfg, train_after_kfs=4)
        for k in range(n_kfs):
            m = lc.process_keyframe(m, k, k)
        assert len(lc.loops) >= 1, f"no loop closed (iters={iters})"
        err = np.linalg.norm(
            np.asarray(m.kf_T_cw)[:n_kfs, :3, 3] - T_true[:n_kfs, :3, 3],
            axis=1)
        results[iters] = float(err.mean())
    assert results[8] < results[0], results


def test_consistent_revisit_skips_correction(rng):
    """Discrepancy gate: on a loop map with NEGLIGIBLE drift the revisit
    verifies geometrically but the measured transform matches the current
    estimate — the system must record a consistent revisit and NOT run
    the whole-map correction (repeated no-op corrections accumulated
    meters of solver noise in the r3 scale rehearsal)."""
    from aslam.models.loopclosing import LoopClosing

    rng2 = np.random.default_rng(11)
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(
        rng2, drift_per_step=1e-5)
    assert drift < 0.005
    lc = LoopClosing(cfg, train_after_kfs=4)
    for k in range(n_kfs):
        m = lc.process_keyframe(m, k, k)
    assert len(lc.loops) == 0, f"no-op correction ran: {lc.loops}"
    assert lc.consistent_revisits, "revisit was not even detected/verified"


def _corridor_map_and_frame(cfg, rng):
    """A 6-KF corridor along +x.  Each KF owns 40 exclusive landmarks;
    adjacent KFs additionally share 20 (covisibility >= 15).  The test
    frame sits at KF 4's pose but its associations carry ONLY a handful of
    KF-3-exclusive landmarks — the covisibility vote alone reaches just
    KF 3 (and its shared neighbors 2/4 via the shared points), while the
    one-hop expansion also pulls in KF 2/4/5's exclusive landmarks."""
    cam = cfg.camera
    M = cfg.extractor.max_keypoints
    n_kfs = 6
    spacing = 0.4

    m = ms.init_map(cfg)
    next_lm = 0
    kf_lms: list[list[int]] = []
    lm_pos_all = {}

    def make_points(x_center, n, key):
        return np.stack([
            rng.uniform(x_center - 0.3, x_center + 0.3, n),
            rng.uniform(-0.8, 0.8, n),
            rng.uniform(2.0, 3.0, n),
        ], -1).astype(np.float32)

    excl = [make_points(k * spacing, 40, k) for k in range(n_kfs)]
    shared = [make_points((k + 0.5) * spacing, 20, 100 + k)
              for k in range(n_kfs - 1)]
    descs = {}

    def add_lm(p):
        nonlocal next_lm
        i = next_lm
        d = rng.integers(0, 2**32, (8,), dtype=np.uint32)
        descs[i] = d
        lm_pos_all[i] = p
        next_lm += 1
        return i

    excl_ids = [[add_lm(p) for p in pts] for pts in excl]
    shared_ids = [[add_lm(p) for p in pts] for pts in shared]

    for k in range(n_kfs):
        ids = list(excl_ids[k])
        if k > 0:
            ids += shared_ids[k - 1]
        if k < n_kfs - 1:
            ids += shared_ids[k]
        kf_lms.append(ids)

    L = cfg.map.max_landmarks
    lm_pos = np.zeros((L, 3), np.float32)
    lm_desc = np.zeros((L, 8), np.uint32)
    lm_valid = np.zeros(L, bool)
    for i in range(next_lm):
        lm_pos[i] = lm_pos_all[i]
        lm_desc[i] = descs[i]
        lm_valid[i] = True
    m = m._replace(lm_pos=jnp.asarray(lm_pos), lm_desc=jnp.asarray(lm_desc),
                   lm_valid=jnp.asarray(lm_valid))

    for k in range(n_kfs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -k * spacing
        ids = kf_lms[k]
        pc = lm_pos[ids] @ T[:3, :3].T + T[:3, 3]
        uv, z = camera.project(cam, jnp.asarray(pc))
        uv, z = np.asarray(uv), np.asarray(z)
        n_f = len(ids)
        kf_xy = np.zeros((M, 2), np.float32)
        kf_z = np.zeros(M, np.float32)
        kf_desc = np.zeros((M, 8), np.uint32)
        kp_valid = np.zeros(M, bool)
        assoc = np.full(M, -1, np.int32)
        kf_xy[:n_f] = uv
        kf_z[:n_f] = z
        kf_desc[:n_f] = lm_desc[ids]
        kp_valid[:n_f] = True
        assoc[:n_f] = ids
        ur = np.where(kf_z > 0,
                      kf_xy[:, 0] - cam.bf / np.maximum(kf_z, 1e-6), -1.0)
        m = m._replace(
            kf_T_cw=m.kf_T_cw.at[k].set(jnp.asarray(T)),
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

    # test frame: at KF 3's pose; features = projections of every landmark
    # of KFs 2..5 (all physically visible); associations = 15 of KF 3's
    # exclusive landmarks only
    T_f = np.eye(4, dtype=np.float32)
    T_f[0, 3] = -3 * spacing
    vis_ids = [i for k in (2, 3, 4, 5) for i in kf_lms[k]]
    vis_ids = list(dict.fromkeys(vis_ids))[:M]
    pc = lm_pos[vis_ids] @ T_f[:3, :3].T + T_f[:3, 3]
    uv, z = camera.project(cam, jnp.asarray(pc))
    uv, z = np.asarray(uv), np.asarray(z)
    n_f = len(vis_ids)
    xy = np.zeros((M, 2), np.float32)
    zf = np.zeros(M, np.float32)
    dsc = np.zeros((M, 8), np.uint32)
    val = np.zeros(M, bool)
    xy[:n_f] = uv
    zf[:n_f] = z
    dsc[:n_f] = lm_desc[vis_ids]
    val[:n_f] = True
    assoc = np.full(M, -1, np.int32)
    k3_excl = set(excl_ids[3])
    n_seed = 0
    for f, i in enumerate(vis_ids):
        if i in k3_excl and n_seed < 15:
            assoc[f] = i
            n_seed += 1
    ur = np.where(zf > 0, xy[:, 0] - cam.bf / np.maximum(zf, 1e-6), -1.0)
    p3d = np.asarray(camera.unproject(cfg.camera, jnp.asarray(xy),
                                      jnp.asarray(zf)))
    feat = Features(
        xy=jnp.asarray(xy), response=jnp.ones(M, jnp.float32),
        angle=jnp.zeros(M, jnp.float32), octave=jnp.zeros(M, jnp.int32),
        desc=jnp.asarray(dsc), valid=jnp.asarray(val),
    )
    frame = FrameData(
        feat=feat, xy_und=jnp.asarray(xy), p3d=jnp.asarray(p3d),
        ur=jnp.asarray(ur.astype(np.float32)), depth=jnp.asarray(zf),
        has_depth=jnp.asarray(zf > 0), T_cw=jnp.asarray(T_f),
        depth_map=jnp.zeros((cfg.camera.height, cfg.camera.width),
                            jnp.float32),
    )
    return m, frame, jnp.asarray(assoc)


def test_local_map_expansion_feeds_weak_regime(rng):
    import dataclasses

    cfg = small_config()
    m, frame, assoc = _corridor_map_and_frame(cfg, rng)

    cfg_off = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, local_map_expand=False))
    cfg_on = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, local_map_expand=True))

    res_off = track_local_map(m, frame, assoc, cfg_off)
    res_on = track_local_map(m, frame, assoc, cfg_on)

    # the expansion must strictly widen the local KF set and the tracked
    # landmark count in this sparse-association regime
    assert int(res_on.local_kf_mask.sum()) > int(res_off.local_kf_mask.sum())
    assert int(res_on.n_tracked) > int(res_off.n_tracked), (
        int(res_off.n_tracked), int(res_on.n_tracked))
    # vote-only reaches exactly the KFs observing the seeded landmarks
    # (KF 3); expansion pulls its covisible neighbors 2 and 4
    assert bool(res_on.local_kf_mask[4]) and not bool(
        res_off.local_kf_mask[4])
