"""Relocalization: a lost frame re-acquires its pose from the BoW database."""

import jax
import jax.numpy as jnp
import numpy as np

from aslam.models.loopclosing import LoopClosing, add_keyframe
from aslam.models.frame import FrameData
from aslam.models.extractor import Features
from aslam.utils import camera

from tests.test_loopclosing import build_looped_map


def frame_from_kf(m, cfg, slot, pose):
    """Fabricate a FrameData with the same observations as KF `slot`."""
    M = m.kf_lm.shape[1]
    xy = m.kf_xy[slot]
    z = m.kf_z[slot]
    feat = Features(
        xy=xy, response=jnp.ones(M), angle=jnp.zeros(M),
        octave=jnp.zeros(M, jnp.int32), desc=m.kf_desc[slot],
        valid=m.kf_kp_valid[slot],
    )
    return FrameData(
        feat=feat, xy_und=xy,
        p3d=camera.unproject(cfg.camera, xy, z),
        ur=m.kf_ur[slot], depth=z, has_depth=z > 0,
        T_cw=jnp.asarray(pose), depth_map=jnp.zeros((1, 1)),
    )


def test_relocalize_recovers_pose(rng):
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    lc = LoopClosing(cfg, train_after_kfs=4)
    lc._maybe_train_vocab(m)
    assert lc.vocab is not None
    for k in range(n_kfs):
        lc.db = add_keyframe(lc.db, lc.vocab, m.kf_desc[k], m.kf_kp_valid[k],
                             jnp.int32(k))

    # a "lost" frame observing exactly what KF 5 saw, with garbage pose
    lost = frame_from_kf(m, cfg, 5, np.eye(4, dtype=np.float32))
    T_reloc = lc.relocalize(m, lost)
    assert T_reloc is not None, "relocalization failed"
    # recovered pose must match KF 5's (estimated) pose
    err = np.linalg.norm(T_reloc[:3, 3] - np.asarray(m.kf_T_cw[5])[:3, 3])
    assert err < 0.02, f"reloc pose error {err}"


def test_relocalize_returns_none_without_vocab(rng):
    cfg, m, *_ = build_looped_map(rng)
    lc = LoopClosing(cfg)
    lost = frame_from_kf(m, cfg, 0, np.eye(4, dtype=np.float32))
    assert lc.relocalize(m, lost) is None


def test_relocalize_rejects_unseen_place(rng):
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(rng)
    lc = LoopClosing(cfg, train_after_kfs=4)
    lc._maybe_train_vocab(m)
    for k in range(n_kfs):
        lc.db = add_keyframe(lc.db, lc.vocab, m.kf_desc[k], m.kf_kp_valid[k],
                             jnp.int32(k))
    # frame with random descriptors/geometry: no candidate should verify
    M = m.kf_lm.shape[1]
    feat = Features(
        xy=jnp.asarray(rng.uniform(10, 300, (M, 2)).astype(np.float32)),
        response=jnp.ones(M), angle=jnp.zeros(M),
        octave=jnp.zeros(M, jnp.int32),
        desc=jnp.asarray(rng.integers(0, 2**32, (M, 8), dtype=np.uint32)),
        valid=jnp.ones(M, bool),
    )
    z = jnp.asarray(rng.uniform(0.5, 3.0, M).astype(np.float32))
    lost = FrameData(
        feat=feat, xy_und=feat.xy,
        p3d=camera.unproject(cfg.camera, feat.xy, z),
        ur=jnp.full(M, -1.0), depth=z, has_depth=z > 0,
        T_cw=jnp.eye(4), depth_map=jnp.zeros((1, 1)),
    )
    assert lc.relocalize(m, lost) is None
