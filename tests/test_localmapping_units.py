"""Unit tests for local-mapping internals (window build, fuse)."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import localmapping as lmm
from aslam.models import mapstate as ms

from tests.test_mapstate import make_test_frame


def build_map_with_kfs(cfg, n_kfs=4, share=0.6):
    """KFs observing overlapping landmark subsets."""
    m = ms.init_map(cfg)
    f = make_test_frame(cfg)
    M = cfg.extractor.max_keypoints
    assoc0 = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc0, jnp.int32(0), jnp.int32(0))
    m, assoc, _ = ms.create_landmarks(
        m, f, assoc0, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth))
    a = np.asarray(assoc)
    bound = np.nonzero(a >= 0)[0]
    for k in range(1, n_kfs):
        a_k = np.full(M, -1, np.int32)
        keep = bound[: int(len(bound) * share)]
        a_k[keep] = a[keep]
        m = ms.insert_keyframe(m, f, jnp.asarray(a_k), jnp.int32(k),
                               jnp.int32(k))
    return m, f


def test_build_window_no_duplicate_cams():
    """Regression: a window camera must never reappear as a fixed anchor
    (double-counted residuals + wrong gauge)."""
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=5)
    spec = lmm.build_window(m, jnp.int32(4), cfg)
    slots = np.asarray(spec.cam_slots)
    valid = np.asarray(spec.cam_valid)
    used = slots[valid]
    assert len(np.unique(used)) == len(used), f"duplicate cams: {used}"
    # current KF is the first window entry and optimizable
    assert used[0] == 4
    assert not np.asarray(spec.cam_fixed)[0]
    # a gauge exists: at least one valid fixed camera (an outside anchor,
    # or — when the whole map is in the window — the oldest window KF)
    fixed_valid = np.asarray(spec.cam_fixed) & valid
    assert fixed_valid.any()
    # the optimizable part is non-empty
    assert (~np.asarray(spec.cam_fixed) & valid).any()


def test_build_problem_masks_foreign_edges():
    """Edges from fixed cams to landmarks outside the optimizable set must
    be invalid (they would corrupt the Schur complement)."""
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=5)
    spec = lmm.build_window(m, jnp.int32(4), cfg)
    prob, lw_ids, n_over = lmm.build_problem(m, spec, cfg)
    e_valid = np.asarray(prob.e_valid)
    e_lm = np.asarray(prob.e_lm)
    point_opt = np.asarray(prob.point_valid)
    assert (point_opt[e_lm[e_valid]]).all()
    assert int(n_over) == 0
    # the problem's landmark axis is the compact window capacity, not the
    # full map table
    assert prob.points.shape[0] == cfg.ba.max_window_points
    # compact ids map back to real landmarks
    ids = np.asarray(lw_ids)
    pv = np.asarray(prob.point_valid)
    lm_valid = np.asarray(m.lm_valid)
    assert lm_valid[ids[pv]].all()
    # round-trip: edge -> local id -> global id equals the KF's binding
    rows = np.asarray(m.kf_lm[np.asarray(spec.cam_slots)]).reshape(-1)
    assert (ids[e_lm[e_valid]] == rows[e_valid]).all()


def test_compact_window_full_size_config():
    """Full-size map capacities: the window problem must stay compact
    ([C, 4096] coupling, <100 MB) and local BA must reduce chi2.  Before
    the compaction this would materialize ~1 GB of W/Y tensors."""
    from aslam.config import SystemConfig
    from aslam.ops import lba as lba_ops

    cfg = SystemConfig()  # 256 KFs x 32768 landmarks, window 64+64
    m, _ = build_map_with_kfs(cfg, n_kfs=4, share=0.7)
    spec = lmm.build_window(m, jnp.int32(3), cfg)
    prob, lw_ids, n_over = lmm.build_problem(m, spec, cfg)
    C = np.asarray(spec.cam_slots).shape[0]
    Lw = prob.points.shape[0]
    assert Lw == cfg.ba.max_window_points == 4096
    w_bytes = C * Lw * 6 * 3 * 4
    assert w_bytes < 100 * 1024 * 1024, f"W tensor {w_bytes/1e6:.0f} MB"
    prob2, stats = lba_ops.local_ba(prob, cfg.camera, cfg.ba)
    assert np.isfinite(float(stats.chi2))
    lm_shape = m.lm_pos.shape  # write_back donates m
    m2 = lmm.write_back(m, spec, prob2, lw_ids, cfg)
    assert m2.lm_pos.shape == lm_shape


def test_fuse_binds_free_features():
    """A KF with unbound features whose neighbors see landmarks projecting
    onto them gets those bindings after fuse."""
    cfg = small_config()
    m, f = build_map_with_kfs(cfg, n_kfs=3, share=0.5)
    before = int(jnp.sum(m.kf_lm[2] >= 0))
    m2 = lmm.fuse_landmarks(m, jnp.int32(2), cfg)
    after = int(jnp.sum(m2.kf_lm[2] >= 0))
    # same frame, same features, same descriptors, same pose -> every
    # landmark of KF 0/1 not yet bound in KF 2 projects exactly onto its
    # own feature and fuses in
    assert after > before
    # no landmark bound twice within the row
    row = np.asarray(m2.kf_lm[2])
    bound = row[row >= 0]
    assert len(np.unique(bound)) == len(bound)


def test_chain_gate_drops_revisit_pairs():
    """Advisor r3 (medium): chain-prior edges must only bind temporally
    near-adjacent keyframes.  A revisit pulls covisibility neighbors with
    far-apart kf_ids into the window; anchoring those pairs at the current
    (drifted) relative transform would pin old-map vs new-map segments
    together exactly where reprojection evidence should align them."""
    cfg = small_config()
    m, f = build_map_with_kfs(cfg, n_kfs=3)
    # simulate a revisit: bump KF 2's id far from KFs 0/1
    m = m._replace(kf_id=m.kf_id.at[2].set(200))
    spec = lmm.build_window(m, jnp.int32(2), cfg)
    chain = lmm.build_chain(m, spec, cfg)
    ids = np.where(np.asarray(spec.cam_valid),
                   np.asarray(m.kf_id[spec.cam_slots]), 2**30)
    w = np.asarray(chain.c_w)
    ci, cj = np.asarray(chain.c_i), np.asarray(chain.c_j)
    gap = ids[cj] - ids[ci]
    # far-apart pairs carry zero weight; near-adjacent pairs carry full
    assert (w[gap > cfg.ba.chain_max_gap] == 0).all()
    near = (gap >= 1) & (gap <= cfg.ba.chain_max_gap) & \
        (ids[ci] < 2**30) & (ids[cj] < 2**30)
    if near.any():
        assert (w[near] == cfg.ba.chain_prior_weight).all()
