"""Property tests for the landmark->observer reverse index (r5).

The fast covisibility primitives (covis_row_fast / kf_votes_of_ids /
landmark_mask_of_slots) must agree with the recompute-from-kf_lm truth
(covis_row / kf_votes) through every mutation the engine performs:
insertion, landmark creation, fuse (bind + merge), landmark culling,
keyframe culling, and LBA-style observation prunes — as long as no
landmark exceeds the observer-ring capacity."""

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import localmapping as lmm
from aslam.models import mapstate as ms

from tests.test_localmapping_units import build_map_with_kfs
from tests.test_mapstate import make_test_frame


def assert_covis_parity(m, msg=""):
    K = m.kf_valid.shape[0]
    for s in range(K):
        slow = np.asarray(ms.covis_row(m, jnp.int32(s)))
        fast = np.asarray(ms.covis_row_fast(m, jnp.int32(s)))
        assert np.array_equal(slow, fast), (
            f"covis mismatch at slot {s} {msg}: slow={slow} fast={fast}")


def test_covis_parity_after_insert_create():
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=5, share=0.6)
    assert_covis_parity(m, "after inserts")


def test_kf_votes_parity():
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=5, share=0.5)
    L = m.lm_pos.shape[0]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, L, 32).astype(np.int32)
    ids = np.unique(ids)
    pad = np.full(32, -1, np.int32)
    pad[: len(ids)] = ids
    valid = jnp.asarray(pad >= 0) & m.lm_valid[jnp.maximum(jnp.asarray(pad), 0)]
    mask = jnp.zeros((L,), bool).at[jnp.maximum(jnp.asarray(pad), 0)].set(
        jnp.asarray(pad >= 0))
    slow = np.asarray(ms.kf_votes(m, mask))
    fast = np.asarray(ms.kf_votes_of_ids(
        m, jnp.maximum(jnp.asarray(pad), 0), valid))
    assert np.array_equal(slow, fast), (slow, fast)


def test_landmark_mask_of_slots_parity():
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=5, share=0.5)
    K = m.kf_valid.shape[0]
    kf_mask = jnp.zeros((K,), bool).at[jnp.asarray([1, 3])].set(True)
    slow = np.asarray(ms.landmark_mask_of_kfs(m, kf_mask))
    fast = np.asarray(ms.landmark_mask_of_slots(
        m, jnp.asarray([1, 3], jnp.int32), jnp.ones(2, bool)))
    assert np.array_equal(slow, fast)


def test_covis_parity_after_fuse_and_culls():
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=5, share=0.7)
    # fuse into the newest KF (exercises bind + merge + redirect)
    m = lmm.fuse_landmarks(m, jnp.int32(4), cfg)
    assert_covis_parity(m, "after fuse")
    # landmark culling
    m = ms.landmark_culling(m, jnp.int32(4), cfg)
    assert_covis_parity(m, "after landmark cull")
    # keyframe culling (self-invalidation of the victim's entries)
    m, _ = ms.keyframe_culling(m, jnp.int32(4), cfg)
    assert_covis_parity(m, "after keyframe cull")


def test_covis_parity_after_observation_prune():
    """Simulated LBA prune: clearing kf_lm entries must drop the
    corresponding observer entries from the fast counts."""
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=4, share=0.8)
    row = np.array(m.kf_lm[2])
    row[::2] = -1          # prune half of KF 2's observations
    m = m._replace(kf_lm=m.kf_lm.at[2].set(jnp.asarray(row)))
    assert_covis_parity(m, "after prune")


def test_descriptor_refresh_ids_matches_mask_version():
    cfg = small_config()
    m, _ = build_map_with_kfs(cfg, n_kfs=4, share=0.6)
    L = m.lm_pos.shape[0]
    row = m.kf_lm[jnp.int32(3)]
    valid = (row >= 0) & m.kf_kp_valid[jnp.int32(3)]
    touched = jnp.zeros((L + 1,), bool).at[
        jnp.where(valid, row, L)].set(True)[:L]
    # both refreshers donate their map argument — hand each its own copy
    m_copy = jax.tree.map(lambda a: a + 0 if hasattr(a, 'dtype') else a, m)
    m_mask = ms.refresh_landmark_descriptors(m, touched, max_obs=8)
    m_ids = ms.refresh_landmark_descriptors_ids(
        m_copy, jnp.maximum(row, 0), valid)
    # both must produce a medoid of the same observation sets; with
    # max_obs 8 vs ring 16 the chosen sets can differ only past 8
    # observations — small_config maps stay under that
    d_mask = np.asarray(m_mask.lm_desc)
    d_ids = np.asarray(m_ids.lm_desc)
    t = np.asarray(touched)
    assert np.array_equal(d_mask[t], d_ids[t])


def test_ring_overflow_undercounts_gracefully():
    """Past max_obs_per_lm observers the ring keeps the NEWEST entries;
    fast covis undercounts but never crashes or overcounts."""
    cfg = small_config()
    O = cfg.map.max_obs_per_lm
    n = min(O + 3, cfg.map.max_keyframes - 1)
    m, _ = build_map_with_kfs(cfg, n_kfs=n + 1, share=1.0)
    slow = np.asarray(ms.covis_row(m, jnp.int32(0)))
    fast = np.asarray(ms.covis_row_fast(m, jnp.int32(0)))
    assert (fast <= slow).all()
    # the newest O observers are still fully counted against each other
    recent = np.asarray(ms.covis_row_fast(m, jnp.int32(n)))
    slow_recent = np.asarray(ms.covis_row(m, jnp.int32(n)))
    assert (recent[n - O + 1:n] == slow_recent[n - O + 1:n]).all()
