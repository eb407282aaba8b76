"""End-to-end frame-to-frame odometry on a synthetic scene (config-1 slice).

The reference validated this stage by running on TUM fr1 and eyeballing ATE
plots; here the synthetic generator gives exact ground truth so the whole
extract -> match -> RANSAC -> motion-BA path is checked quantitatively.
"""

import numpy as np

from aslam.config import small_config
from aslam.models.vo import VisualOdometry
from aslam.utils import synthetic, trajectory, se3


def test_vo_tracks_synthetic_sequence():
    imgs, depths, poses_gt, _ = synthetic.make_sequence(
        n_frames=6, n_points=500, seed=3
    )
    vo = VisualOdometry(small_config())
    for i in range(len(imgs)):
        vo.process(imgs[i], depths[i], t=i * 0.03)

    assert len(vo.poses) == 6
    # enough matches/inliers on every tracked frame
    for s in vo.stats:
        assert s["n_matches"] >= 30, s
        assert s["n_inliers"] >= 20, s

    centers_est = np.stack([np.asarray(se3.T_inv(T))[:3, 3] for T in vo.poses])
    centers_gt = np.stack([np.asarray(se3.T_inv(T))[:3, 3] for T in poses_gt])
    ate = trajectory.ate_rmse(centers_est, centers_gt)
    # frame steps are ~2 cm; demand sub-centimeter ATE over the clip
    assert ate < 0.01, f"ATE {ate:.4f} m too high"

    # rotation error of the final pose
    R_err = np.asarray(vo.poses[-1])[:3, :3] @ poses_gt[-1][:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 1.0, f"final rotation error {ang:.2f} deg"


def test_vo_with_icl_camera_preset():
    """ICL-NUIM preset has negative fy (flipped y axis) — the whole
    pipeline must be sign-safe."""
    from aslam.config import ICL_NUIM, small_config
    import dataclasses

    cam = dataclasses.replace(ICL_NUIM, width=320, height=240,
                              cx=160.0, cy=120.0, fx=240.0, fy=-240.0)
    cfg = small_config().replace(camera=cam)
    imgs, depths, poses_gt, _ = synthetic.make_sequence(
        n_frames=4, n_points=400, cam=cam, seed=13)
    vo = VisualOdometry(cfg)
    for i in range(4):
        T = vo.process(imgs[i], depths[i], t=i * 0.03)
    assert np.isfinite(T).all()
    for s in vo.stats:
        assert s["n_matches"] > 20, s


def test_track_sequence_matches_streaming_loop():
    """`track_sequence` (lax.scan chunk, one dispatch) must be exactly the
    chained `track_frame` recurrence — same poses, stats, and adaptive
    threshold state as the streaming path."""
    import jax
    import jax.numpy as jnp

    from aslam.config import small_config
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.models.odometry import track_frame, track_sequence

    cfg = small_config()
    cam = cfg.camera
    n = 5
    imgs, depths, poses_gt, _ = synthetic.make_sequence(
        n_frames=n, n_points=400, cam=cam, seed=7)
    imgs_u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    depths_u16 = np.clip(depths / cam.depth_factor, 0, 65535).astype(np.uint16)
    keys = jax.random.split(jax.random.PRNGKey(11), n)

    state = init_adaptive_state(cfg.extractor)
    f0, state = frame_mod.make_frame(
        jnp.asarray(imgs_u8[0]), jnp.asarray(depths_u16[0]), cfg, state)
    f0 = frame_mod.with_pose(f0, jnp.eye(4))

    # streaming: one dispatch per frame
    prev, grid = f0, state.grid_thresholds
    stream_poses, stream_stats = [], []
    for i in range(1, n):
        prev, grid, res = track_frame(
            prev, jnp.asarray(imgs_u8[i]), jnp.asarray(depths_u16[i]),
            grid, keys[i], cfg, cam.height, cam.width)
        stream_poses.append(np.asarray(res.T_cw2))
        stream_stats.append((int(res.n_matches), int(res.n_inliers)))

    # chunked: one dispatch for all frames
    last, grid2, seq = track_sequence(
        f0, jnp.asarray(imgs_u8[1:]), jnp.asarray(depths_u16[1:]),
        state.grid_thresholds, keys[1:], cfg, cam.height, cam.width)

    # trajectory-level agreement (bitwise equality is not guaranteed
    # across differently-fused XLA programs — see test_batch_vo)
    np.testing.assert_allclose(
        np.asarray(seq.T_cw), np.stack(stream_poses), rtol=0, atol=0.01)
    for (m_c, i_c), (m_s, i_s) in zip(
            [(int(m), int(i)) for m, i in zip(seq.n_matches, seq.n_inliers)],
            stream_stats):
        # counts sit on gate boundaries; differently-fused programs may
        # flip a handful of borderline matches (pose agreement above is
        # the real contract)
        assert abs(m_c - m_s) <= 10 and abs(i_c - i_s) <= 10
    np.testing.assert_allclose(np.asarray(grid2), np.asarray(grid),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(last.T_cw),
                               np.asarray(prev.T_cw), rtol=0, atol=0.01)
