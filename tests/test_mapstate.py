"""MapState array-land semantics: insertion, landmark creation, derived
structures, culling."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import frame as frame_mod
from aslam.models import mapstate as ms
from aslam.models.extractor import init_adaptive_state
from aslam.utils import synthetic


def make_test_frame(cfg, seed=0, pose=None):
    imgs, depths, poses, pts = synthetic.make_sequence(
        n_frames=1, n_points=300, cam=cfg.camera, seed=seed
    )
    state = init_adaptive_state(cfg.extractor)
    f, _ = frame_mod.make_frame(
        jnp.asarray(imgs[0]), jnp.asarray(depths[0]), cfg, state
    )
    return frame_mod.with_pose(f, jnp.asarray(pose if pose is not None else poses[0]))


def test_insert_and_create_landmarks():
    cfg = small_config()
    m = ms.init_map(cfg)
    f = make_test_frame(cfg)
    M = cfg.extractor.max_keypoints
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc, jnp.int32(0), jnp.int32(0))
    assert bool(m.kf_valid[0])
    m, assoc, n_created = ms.create_landmarks(
        m, f, assoc, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth),
    )
    n = int(n_created)
    assert n > 20
    assert int(jnp.sum(m.lm_valid)) == n
    assert int(jnp.sum(assoc >= 0)) == n
    # bindings recorded in the KF row
    np.testing.assert_array_equal(np.asarray(m.kf_lm[0]), np.asarray(assoc))
    # landmark positions: world = camera since pose is first frame
    obs = ms.observation_counts(m)
    assert int(obs.max()) == 1
    assert int(jnp.sum(obs)) == n


def test_create_landmarks_respects_max_new():
    cfg = small_config()
    m = ms.init_map(cfg)
    f = make_test_frame(cfg)
    M = cfg.extractor.max_keypoints
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc, jnp.int32(0), jnp.int32(0))
    m, assoc, n_created = ms.create_landmarks(
        m, f, assoc, jnp.int32(0), jnp.int32(0),
        max_new=10, th_depth=float(cfg.camera.th_depth),
    )
    assert int(n_created) == 10
    # the 10 chosen are the closest eligible features
    chosen_z = np.asarray(f.depth)[np.asarray(assoc) >= 0]
    eligible = np.asarray(f.has_depth) & (np.asarray(f.depth) < cfg.camera.th_depth) \
        & np.asarray(f.feat.valid)
    all_z = np.sort(np.asarray(f.depth)[eligible])
    assert np.max(chosen_z) <= all_z[min(10, len(all_z)) - 1] + 1e-5


def test_covisibility_counts_shared():
    cfg = small_config()
    m = ms.init_map(cfg)
    f = make_test_frame(cfg)
    M = cfg.extractor.max_keypoints
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc, jnp.int32(0), jnp.int32(0))
    m, assoc, n0 = ms.create_landmarks(
        m, f, assoc, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth),
    )
    # second KF shares ~half the landmarks
    assoc2 = np.full(M, -1, np.int32)
    shared = np.asarray(assoc) >= 0
    idx = np.nonzero(shared)[0]
    take = idx[: len(idx) // 2]
    assoc2[take] = np.asarray(assoc)[take]
    m = ms.insert_keyframe(m, f, jnp.asarray(assoc2), jnp.int32(1), jnp.int32(1))
    W = np.asarray(ms.covisibility(m))
    assert W[0, 1] == W[1, 0] == len(take)
    assert W[0, 0] == 0


def _random_map(cfg, k_used=12, n_lm=300, seed=0):
    """Hand-built multi-KF map with tombstones, for derived-structure
    equivalence tests."""
    rng = np.random.default_rng(seed)
    m = ms.init_map(cfg)
    K = cfg.map.max_keyframes
    M = cfg.extractor.max_keypoints
    L = cfg.map.max_landmarks
    kf_valid = np.zeros(K, bool)
    kf_valid[:k_used] = True
    kf_valid[3] = False                      # culled slot
    kf_lm = np.full((K, M), -1, np.int32)
    kp_valid = np.zeros((K, M), bool)
    lm_valid = np.zeros(L, bool)
    lm_valid[:n_lm] = True
    lm_valid[5] = False                      # tombstoned landmark
    for k in range(k_used):
        n_obs = int(rng.integers(30, min(120, M)))
        feats = rng.choice(M, n_obs, replace=False)
        lms = rng.choice(n_lm, n_obs, replace=False)
        kf_lm[k, feats] = lms
        kp_valid[k, feats] = True
    # an invalid-keypoint binding that must be ignored everywhere
    kf_lm[0, np.nonzero(~kp_valid[0])[0][0]] = 7
    m = m._replace(
        kf_valid=jnp.asarray(kf_valid),
        kf_lm=jnp.asarray(kf_lm),
        kf_kp_valid=jnp.asarray(kp_valid),
        lm_valid=jnp.asarray(lm_valid),
        kf_id=jnp.asarray(
            np.where(kf_valid, np.arange(K), -1).astype(np.int32)),
    )
    return ms.rebuild_observer_index(m)


def test_scale_primitives_match_dense():
    """kf_votes / landmark_mask_of_kfs / covis_row(s) / blocked
    covisibility must equal the dense incidence formulation exactly —
    they replace it on every per-frame/per-KF path at scale."""
    cfg = small_config()
    m = _random_map(cfg)
    K = cfg.map.max_keyframes
    L = cfg.map.max_landmarks
    rng = np.random.default_rng(1)

    A = np.asarray(ms.incidence(m))
    W = (A.astype(np.int64) @ A.T)
    np.fill_diagonal(W, 0)
    kv = np.asarray(m.kf_valid)
    W = W * np.outer(kv, kv)

    for s in [0, 2, 3]:
        np.testing.assert_array_equal(
            np.asarray(ms.covis_row(m, jnp.int32(s))), W[s])
    sel = jnp.asarray([0, 1, 4, 11], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(ms.covis_rows(m, sel)), W[[0, 1, 4, 11]])

    lm_mask = rng.uniform(size=L) < 0.3
    votes_dense = A.astype(np.int64) @ (
        lm_mask & np.asarray(m.lm_valid)).astype(np.int64)
    np.testing.assert_array_equal(
        np.asarray(ms.kf_votes(m, jnp.asarray(lm_mask))), votes_dense)

    kf_mask = rng.uniform(size=K) < 0.4
    mask_dense = np.any(A[kf_mask & kv], axis=0)
    np.testing.assert_array_equal(
        np.asarray(ms.landmark_mask_of_kfs(m, jnp.asarray(kf_mask))),
        mask_dense)

    # blocked covisibility (chunk < K exercises the scan path) == dense
    np.testing.assert_array_equal(
        np.asarray(ms.covisibility(m, chunk=8)), W)
    np.testing.assert_array_equal(np.asarray(ms.covisibility(m)), W)


def test_landmark_culling_low_found_ratio():
    cfg = small_config()
    m = ms.init_map(cfg)
    f = make_test_frame(cfg)
    M = cfg.extractor.max_keypoints
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc, jnp.int32(0), jnp.int32(0))
    m, assoc, n = ms.create_landmarks(
        m, f, assoc, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth),
    )
    n = int(n)
    # landmark 0: visible 10 found 1 (ratio 0.1 < 0.25) -> culled
    m = m._replace(
        lm_visible=m.lm_visible.at[0].set(10),
        lm_found=m.lm_found.at[0].set(1),
    )
    m2 = ms.landmark_culling(m, jnp.int32(0), cfg)
    assert not bool(m2.lm_valid[0])
    # its observation was unbound
    assert not np.any(np.asarray(m2.kf_lm) == 0)
    # others with no visibility stats survive while young
    assert int(jnp.sum(m2.lm_valid)) == n - 1


def test_refresh_descriptors_picks_medoid():
    cfg = small_config()
    m = ms.init_map(cfg)
    L = cfg.map.max_landmarks
    M = cfg.extractor.max_keypoints
    f = make_test_frame(cfg)
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc, jnp.int32(0), jnp.int32(0))
    m, assoc, _ = ms.create_landmarks(
        m, f, assoc, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth),
    )
    mask = jnp.ones((L,), bool)
    m2 = ms.refresh_landmark_descriptors(m, mask)
    # single observation -> descriptor equals the observing feature's
    a = np.asarray(assoc)
    feats = np.asarray(f.feat.desc)
    for i in np.nonzero(a >= 0)[0][:10]:
        np.testing.assert_array_equal(
            np.asarray(m2.lm_desc[a[i]]), feats[i]
        )


def test_landmark_culling_stereo_counts_double():
    """Reference nObs semantics (landmark.cpp:69-80, localmapping.cpp:122-128):
    depth observations count twice toward the obs<=3 maturity cull — one
    stereo observation (nObs=2) dies, two stereo observations (nObs=4)
    survive."""
    cfg = small_config()
    m = ms.init_map(cfg)
    f = make_test_frame(cfg)
    M = cfg.extractor.max_keypoints
    assoc = jnp.full((M,), -1, jnp.int32)
    m = ms.insert_keyframe(m, f, assoc, jnp.int32(0), jnp.int32(0))
    m, assoc, n = ms.create_landmarks(
        m, f, assoc, jnp.int32(0), jnp.int32(0),
        max_new=M, th_depth=float(cfg.camera.th_depth),
    )
    # landmark 0 observed (with depth) by a second keyframe too
    feat0 = int(np.nonzero(np.asarray(assoc) == 0)[0][0])
    assoc2 = np.full(M, -1, np.int32)
    assoc2[feat0] = 0
    m = ms.insert_keyframe(m, f, jnp.asarray(assoc2), jnp.int32(1),
                           jnp.int32(1))

    obs2 = np.asarray(ms.observation_counts_weighted(m))
    assert obs2[0] == 4          # two stereo observations
    single = np.asarray(assoc) >= 0
    single[feat0] = False

    # mature cull (>=2 KFs after creation): nObs=2 single-stereo landmarks
    # die, the nObs=4 landmark survives
    m3 = ms.landmark_culling(m, jnp.int32(4), cfg)
    valid = np.asarray(m3.lm_valid)
    assert bool(valid[0])
    assert not valid[np.asarray(assoc)[np.nonzero(single)[0]]].any()
