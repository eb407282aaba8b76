"""Long-run stability: 24-frame synthetic trajectory through the full
host SLAM system — exercises repeated keyframe insertion, culling, fuse,
and local BA cycles for capacity/mask regressions that short clips miss."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models.system import SlamSystem
from aslam.utils import synthetic, trajectory, se3


def test_long_run_stable():
    cfg = small_config()
    rng = np.random.default_rng(11)
    pts = synthetic.random_scene(rng, 700, extent=4.0)
    poses = synthetic.camera_trajectory(24, step_t=0.045, step_r=0.02, rng=rng)
    tex = synthetic.point_textures(700, seed=12)
    slam = SlamSystem(cfg)
    for i, T in enumerate(poses):
        img = synthetic.render_intensity_image(cfg.camera, T, pts, tex)
        dep = synthetic.render_depth_image(cfg.camera, T, pts, splat=4)
        slam.process(img, dep, t=i * 0.033)

    st = slam.tracking.stats
    tracked = [s.get("n_tracked", 0) for s in st[1:]]
    # never collapse (min tracked above the lost threshold most of the run)
    assert np.median(tracked) > 40, tracked
    assert min(tracked) > 10, tracked
    # multiple keyframes, map stayed within capacity
    assert 3 <= slam.tracking.n_kfs <= cfg.map.max_keyframes
    n_lms = int(jnp.sum(slam.map.lm_valid))
    assert 0 < n_lms <= cfg.map.max_landmarks
    assert slam.tracking.next_lm <= cfg.map.max_landmarks, \
        "landmark allocation overflowed capacity"

    est = np.stack([np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3]
                    for T in slam.tracking.poses])
    gt = np.stack([np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3]
                   for T in poses])
    ate = trajectory.ate_rmse(est, gt)
    assert ate < 0.06, f"ATE {ate:.4f} m over 24 frames"
