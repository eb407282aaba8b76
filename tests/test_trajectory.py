import numpy as np

from aslam.utils import se3, synthetic, trajectory


def test_save_load_roundtrip(tmp_path, rng):
    poses = synthetic.camera_trajectory(10, rng=rng)
    ts = np.arange(10, dtype=np.float64) * 0.033
    path = str(tmp_path / "traj.txt")
    trajectory.save_tum_trajectory(path, ts, poses)
    ts2, pos, quat = trajectory.load_tum_trajectory(path)
    np.testing.assert_allclose(ts2, ts, atol=1e-5)
    # positions should equal camera centers (Twc translation = -R^T t)
    for i in range(10):
        T_wc = np.asarray(se3.T_inv(poses[i]))
        np.testing.assert_allclose(pos[i], T_wc[:3, 3], atol=1e-5)


def test_ate_zero_for_identical(rng):
    poses = synthetic.camera_trajectory(20, rng=rng)
    centers = np.stack([np.asarray(se3.T_inv(T))[:3, 3] for T in poses])
    assert trajectory.ate_rmse(centers, centers) < 1e-6


def test_ate_invariant_to_rigid_offset(rng):
    centers = rng.normal(0, 1, (30, 3))
    xi = np.concatenate([rng.normal(0, 1, 3), rng.normal(0, 0.5, 3)]).astype(np.float32)
    T = np.asarray(se3.se3_exp(xi))
    moved = centers @ T[:3, :3].T + T[:3, 3]
    assert trajectory.ate_rmse(moved, centers) < 1e-5


def test_rpe(rng):
    poses = synthetic.camera_trajectory(15, rng=rng)
    t_err, r_err = trajectory.rpe_rmse(poses, poses)
    assert t_err < 1e-6 and r_err < 1e-3


def test_synthetic_sequence_shapes():
    imgs, depths, poses, pts = synthetic.make_sequence(n_frames=3, n_points=100)
    assert imgs.shape == (3, 240, 320)
    assert depths.shape == (3, 240, 320)
    assert poses.shape == (3, 4, 4)
    assert pts.shape == (100, 3)
    # depth map should contain the scene depths where points project
    assert (depths > 0).sum() > 100


def test_device_ate_matches_host(rng):
    import jax.numpy as jnp

    poses = synthetic.camera_trajectory(15, rng=rng)
    # perturb a copy
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.01, (15, 3)).astype(np.float32)
    host = trajectory.ate_rmse(
        np.stack([np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3] for T in noisy]),
        np.stack([np.asarray(se3.T_inv(jnp.asarray(T)))[:3, 3] for T in poses]),
    )
    dev = float(trajectory.ate_rmse_device(jnp.asarray(noisy), jnp.asarray(poses)))
    assert abs(host - dev) < 1e-4
