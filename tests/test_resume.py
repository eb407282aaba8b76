"""Checkpoint -> resume -> continue tracking (config-5 requirement)."""

import numpy as np

from aslam.config import small_config
from aslam.models.system import SlamSystem
from aslam.utils import checkpoint, synthetic


def test_resume_continues_tracking(tmp_path):
    cfg = small_config()
    rng = np.random.default_rng(21)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(10, step_t=0.04, rng=rng)
    tex = synthetic.point_textures(500, seed=22)
    imgs = np.stack([synthetic.render_intensity_image(cfg.camera, T, pts, tex)
                     for T in poses])
    deps = np.stack([synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
                     for T in poses])

    slam = SlamSystem(cfg)
    for i in range(6):
        slam.process(imgs[i], deps[i], t=i * 0.033)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_system(path, slam)
    kfs_before = slam.tracking.n_kfs

    slam2 = SlamSystem(cfg)
    checkpoint.load_system(path, slam2)
    assert slam2.tracking.state == "NEW_SEQUENCE"
    for i in range(6, 10):
        T, info = slam2.process(imgs[i], deps[i], t=i * 0.033)
    # resumed run keeps the map and tracks against it
    assert slam2.tracking.n_kfs >= kfs_before
    tracked = [s.get("n_tracked", 0) for s in slam2.tracking.stats[1:]]
    assert max(tracked) > 20, tracked


def test_combined_gicp_loop_config():
    """Config-3 combo (GICP policy + loop closing) runs end to end."""
    cfg = small_config().replace(use_gicp=True, use_loop_closing=True)
    rng = np.random.default_rng(23)
    pts = synthetic.random_scene(rng, 400)
    poses = synthetic.camera_trajectory(6, step_t=0.04, rng=rng)
    tex = synthetic.point_textures(400, seed=24)
    slam = SlamSystem(cfg)
    for i, T in enumerate(poses):
        img = synthetic.render_intensity_image(cfg.camera, T, pts, tex)
        dep = synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
        Tout, info = slam.process(img, dep, t=i * 0.033)
    assert np.isfinite(np.asarray(Tout)).all()
    assert slam.tracking.n_kfs >= 1


def test_sensor_dropout_recovery():
    """Blank frames mid-sequence (sensor dropout): the system must not
    crash, must flag LOST, and must keep producing finite poses when
    frames return."""
    cfg = small_config().replace(use_loop_closing=True)
    rng = np.random.default_rng(31)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(12, step_t=0.04, rng=rng)
    tex = synthetic.point_textures(500, seed=32)
    slam = SlamSystem(cfg)
    states = []
    for i, T in enumerate(poses):
        if i in (5, 6):
            img = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
            dep = np.zeros_like(img)
        else:
            img = synthetic.render_intensity_image(cfg.camera, T, pts, tex)
            dep = synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
        Tout, info = slam.process(img, dep, t=i * 0.033)
        states.append(slam.tracking.state)
        assert np.isfinite(np.asarray(Tout)).all(), f"non-finite pose at {i}"
    # dropout frames flagged LOST
    assert "LOST" in states[5:8], states
    # recovered tracking by the end
    tail = [s.get("n_tracked", 0) for s in slam.tracking.stats[-3:]]
    assert max(tail) > 20, (states, tail)


def test_resume_with_loop_database(tmp_path):
    """Vocabulary + BoW database survive checkpoint/resume."""
    import jax.numpy as jnp

    from aslam.ops import bow

    cfg = small_config().replace(use_loop_closing=True)
    rng = np.random.default_rng(41)
    pts = synthetic.random_scene(rng, 500)
    poses = synthetic.camera_trajectory(10, step_t=0.05, rng=rng)
    tex = synthetic.point_textures(500, seed=42)
    slam = SlamSystem(cfg)
    for i, T in enumerate(poses):
        img = synthetic.render_intensity_image(cfg.camera, T, pts, tex)
        dep = synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
        slam.process(img, dep, t=i * 0.033)
    if slam.loop_closing.vocab is None:
        # not enough keyframes to train -> nothing to persist; still valid
        return
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_system(path, slam)

    slam2 = SlamSystem(cfg)
    checkpoint.load_system(path, slam2)
    assert slam2.loop_closing.vocab is not None
    # identical word assignment after reload
    desc = np.asarray(slam.map.kf_desc[0])[:64]
    w1 = np.asarray(bow.transform(slam.loop_closing.vocab, jnp.asarray(desc)))
    w2 = np.asarray(bow.transform(slam2.loop_closing.vocab, jnp.asarray(desc)))
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(
        np.asarray(slam.loop_closing.db.kf_in_db),
        np.asarray(slam2.loop_closing.db.kf_in_db))
