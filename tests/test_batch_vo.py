"""Batched VO: B sequences in one device program track like B single runs."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models.batch_vo import BatchVisualOdometry
from aslam.models.vo import VisualOdometry
from aslam.utils import synthetic, trajectory, se3


def test_batch_vo_matches_single_runs():
    cfg = small_config()
    B, F = 3, 4
    seqs = [synthetic.make_sequence(n_frames=F, n_points=400, seed=10 + b)
            for b in range(B)]

    bvo = BatchVisualOdometry(cfg, batch=B, seed=0)
    for f in range(F):
        imgs = np.stack([seqs[b][0][f] for b in range(B)])
        deps = np.stack([seqs[b][1][f] for b in range(B)])
        bvo.process(imgs, deps)
    batch_traj = bvo.trajectories()           # [F-1, B, 4, 4]
    assert batch_traj.shape == (F - 1, B, 4, 4)
    assert np.isfinite(batch_traj).all()

    # each sequence individually tracked stays close to ground truth
    for b in range(B):
        gt = seqs[b][2]
        est_centers = np.stack([
            np.asarray(se3.T_inv(jnp.asarray(batch_traj[f, b])))[:3, 3]
            for f in range(F - 1)
        ])
        gt_centers = np.stack([
            np.asarray(se3.T_inv(jnp.asarray(gt[f + 1])))[:3, 3]
            for f in range(F - 1)
        ])
        ate = trajectory.ate_rmse(est_centers, gt_centers)
        assert ate < 0.02, f"seq {b}: ATE {ate:.4f}"


def test_batch_chunk_matches_streaming():
    """process_chunk (vmap x scan, one dispatch) reproduces the
    frame-by-frame batched path: same PRNG recurrence, same detections.
    Poses agree to trajectory level rather than bitwise — the two compiled
    programs reassociate the IC-angle reduction differently (~1e-6 rad),
    which can flip individual rBRIEF bits and hence single match pairs."""
    cfg = small_config()
    B, F = 2, 5
    seqs = [synthetic.make_sequence(n_frames=F, n_points=400, seed=20 + b)
            for b in range(B)]
    imgs = np.stack([seqs[b][0] for b in range(B)])    # [B,F,H,W]
    deps = np.stack([seqs[b][1] for b in range(B)])

    stream = BatchVisualOdometry(cfg, batch=B, seed=1)
    for f in range(F):
        stream.process(imgs[:, f], deps[:, f])
    traj_s = stream.trajectories()

    chunked = BatchVisualOdometry(cfg, batch=B, seed=1)
    chunked.process_chunk(imgs[:, :3], deps[:, :3])
    chunked.process_chunk(imgs[:, 3:], deps[:, 3:])
    traj_c = chunked.trajectories()

    # rotation entries are dimensionless (0.01 ~ 0.6 deg), translations in
    # metres on ~2-5 cm frame steps
    np.testing.assert_allclose(traj_c, traj_s, rtol=0, atol=0.01)
    # detection is unaffected by the angle reassociation: thresholds exact
    np.testing.assert_allclose(np.asarray(chunked.grids),
                               np.asarray(stream.grids), rtol=0, atol=0)
