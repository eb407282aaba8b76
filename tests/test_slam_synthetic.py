"""Full SLAM integration (config-2 scope): tracking + keyframes + local
mapping + local BA on a synthetic sequence with ground truth."""

import numpy as np
import jax.numpy as jnp

from aslam.config import small_config
from aslam.models import mapstate as ms
from aslam.models.system import SlamSystem
from aslam.utils import synthetic, trajectory, se3


def run_system(n_frames=10, step_t=0.05, seed=4, n_points=500):
    cam = small_config().camera
    rng = np.random.default_rng(seed)
    pts = synthetic.random_scene(rng, n_points)
    poses = synthetic.camera_trajectory(n_frames, step_t=step_t, step_r=0.02,
                                       rng=rng)
    tex = synthetic.point_textures(n_points, seed=seed + 1)
    imgs = np.stack([
        synthetic.render_intensity_image(cam, T, pts, tex) for T in poses
    ])
    depths = np.stack([
        synthetic.render_depth_image(cam, T, pts, splat=4) for T in poses
    ])
    slam = SlamSystem(small_config(), seed=seed)
    for i in range(n_frames):
        slam.process(imgs[i], depths[i], t=i * 0.033)
    return slam, poses


def test_slam_tracks_and_maps():
    slam, poses_gt = run_system()
    # keyframes were inserted (0.05 m steps exceed the 0.15 m trigger
    # roughly every 3 frames)
    assert slam.tracking.n_kfs >= 2, "no keyframes beyond init"
    m = slam.map
    assert int(jnp.sum(m.kf_valid)) == slam.tracking.n_kfs
    n_lms = int(jnp.sum(m.lm_valid))
    assert n_lms > 50

    # tracked landmark count healthy on later frames
    tracked = [s.get("n_tracked", 0) for s in slam.tracking.stats[1:]]
    assert min(tracked) > 20, f"tracking collapsed: {tracked}"

    # trajectory accuracy
    est = np.stack([np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3]
                    for T in slam.tracking.poses])
    gt = np.stack([np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3]
                   for T in poses_gt])
    ate = trajectory.ate_rmse(est, gt)
    assert ate < 0.03, f"ATE {ate:.4f} m"


def test_slam_covisibility_structure():
    slam, _ = run_system()
    m = slam.map
    if slam.tracking.n_kfs >= 2:
        W = np.asarray(ms.covisibility(m))
        # consecutive keyframes must share observations
        assert W[0, 1] > 0 or slam.tracking.n_kfs > 2


def test_slam_trajectory_export(tmp_path):
    slam, _ = run_system(n_frames=6)
    p1 = str(tmp_path / "traj.txt")
    p2 = str(tmp_path / "kf.txt")
    slam.save_trajectory(p1)
    slam.save_keyframe_trajectory(p2)
    ts, pos, quat = trajectory.load_tum_trajectory(p1)
    assert len(ts) == 6
    ts2, _, _ = trajectory.load_tum_trajectory(p2)
    assert len(ts2) == slam.tracking.n_kfs
