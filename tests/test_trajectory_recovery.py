"""Retro-corrected trajectory export (reference tracking.cpp:544-582).

The reference records each frame's pose relative to its reference keyframe
(`mlRelativeFramePoses`) and rebuilds the trajectory from FINAL keyframe
poses at save time, walking the bad-KF parent chain (`mTcp`,
keyframe.cpp:506) when the reference KF was culled.  These tests prove the
device engine's equivalent: map corrections (local BA, loop closure, culling)
propagate into the exported trajectory retroactively."""

import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.models import mapstate as ms
from aslam.models.system import SlamSystem
from aslam.utils import synthetic, trajectory, se3

from tests.test_slam_synthetic import run_system


def test_rebuilt_matches_frozen_without_correction():
    """With untouched KF poses, the rebuilt trajectory equals the frozen
    per-frame poses up to local-BA refinement (small on a clean clip)."""
    slam, _ = run_system(n_frames=8)
    frozen = np.stack(slam.tracking.poses)
    rebuilt = slam.rebuilt_trajectory()
    assert rebuilt.shape == frozen.shape
    # same clip, consistent scale: poses agree to centimeters
    d = np.linalg.norm(rebuilt[:, :3, 3] - frozen[:, :3, 3], axis=1)
    assert d.max() < 0.05, f"max deviation {d.max():.4f} m"


def test_rebuilt_absorbs_map_correction():
    """Shift every final KF pose by a known rigid transform G (stand-in for
    a loop-closure correction): the rebuilt trajectory must follow G, the
    frozen export cannot."""
    slam, _ = run_system(n_frames=8)
    G = np.eye(4, dtype=np.float32)
    G[:3, 3] = [0.3, -0.2, 0.1]
    m = slam.map
    corrected = jnp.asarray(np.asarray(m.kf_T_cw) @ G)  # T_cw' = T_cw @ G
    slam.tracking.map = m._replace(kf_T_cw=corrected)

    frozen = np.stack(slam.tracking.poses)
    rebuilt = slam.rebuilt_trajectory()
    expect = frozen @ G
    err = np.abs(rebuilt - expect).max()
    # every frame's rebuilt pose = T_cr @ (T_rw_old @ G) = old T_cw @ G
    # up to local-BA deltas already present in the KF table
    d = np.linalg.norm(rebuilt[:, :3, 3] - expect[:, :3, 3], axis=1)
    assert d.max() < 0.05, f"correction not absorbed, max {d.max():.4f} m"
    # and it genuinely differs from the frozen export
    d_frozen = np.linalg.norm(rebuilt[:, :3, 3] - frozen[:, :3, 3], axis=1)
    assert d_frozen.max() > 0.2


def test_rebuilt_walks_culled_parent_chain():
    """Frames whose reference KF was culled recover through the culled-KF
    registry: T_cw = T_cr @ T_rp @ ... @ T_aw(final) for the surviving
    ancestor a (tracking.cpp:564-567)."""
    slam, _ = run_system(n_frames=8)
    tr = slam.tracking
    m = tr.map
    kf_ids = np.asarray(m.kf_id)
    kf_valid = np.asarray(m.kf_valid)
    live = sorted(int(i) for i in kf_ids[kf_valid])
    assert len(live) >= 2
    victim_id = live[-1]
    parent_id = live[0]
    vslot = int(np.nonzero(kf_ids == victim_id)[0][0])
    pslot = int(np.nonzero(kf_ids == parent_id)[0][0])

    before = slam.rebuilt_trajectory()

    # cull the newest KF manually, recording its parent-chain entry the way
    # LocalMapping.process_keyframe does
    T_v = np.asarray(m.kf_T_cw[vslot])
    T_p = np.asarray(m.kf_T_cw[pslot])
    slam.local_mapping.culled[victim_id] = (
        parent_id, T_v @ np.linalg.inv(T_p),
    )
    slam.tracking.map = m._replace(kf_valid=m.kf_valid.at[vslot].set(False))

    after = slam.rebuilt_trajectory()
    d = np.linalg.norm(after[:, :3, 3] - before[:, :3, 3], axis=1)
    assert d.max() < 1e-4, f"chain walk changed poses by {d.max():.6f} m"


def test_loop_correction_improves_exported_ate():
    """End-to-end: on a drifted looped map, pose-graph correction must
    reduce the ATE of the REBUILT trajectory vs the frozen export — the
    capability the frozen export structurally lacks (VERDICT missing #2)."""
    from aslam.models.loopclosing import build_pose_graph, correct_map
    from aslam.ops import pose_graph as pg_ops

    from tests.test_loopclosing import build_looped_map

    rng = np.random.default_rng(7)
    cfg, m, T_true, T_est, drift, n_kfs = build_looped_map(
        rng, n_kfs=14, drift_per_step=0.04
    )
    # synthesize per-frame records: 2 frames per KF interval, each relative
    # to its (drifted) reference KF but with TRUE relative motion
    slam = SlamSystem(cfg)
    tr = slam.tracking
    for k in range(n_kfs):
        tr.poses.append(T_est[k])
        tr.timestamps.append(float(k))
        tr.ref_kf_ids.append(k)
        tr.rel_poses.append(np.eye(4))
        if k + 1 < n_kfs:
            # midpoint frame between true poses, referenced to KF k
            T_mid = T_true[k].copy()
            T_mid[:3, 3] = 0.5 * (T_true[k][:3, 3] + T_true[k + 1][:3, 3])
            tr.poses.append(T_mid @ np.linalg.inv(T_true[k]) @ T_est[k])
            tr.timestamps.append(k + 0.5)
            tr.ref_kf_ids.append(k)
            tr.rel_poses.append(T_mid @ np.linalg.inv(T_true[k]))
    tr.map = m

    # ground-truth camera centers for every frame
    def centers(Ts):
        return np.stack([np.linalg.inv(T)[:3, 3] for T in Ts])

    gt = []
    for k in range(n_kfs):
        gt.append(T_true[k])
        if k + 1 < n_kfs:
            T_mid = T_true[k].copy()
            T_mid[:3, 3] = 0.5 * (T_true[k][:3, 3] + T_true[k + 1][:3, 3])
            gt.append(T_mid)
    gt_c = centers(gt)

    frozen_ate = trajectory.ate_rmse(centers(np.stack(tr.poses)), gt_c)

    # close the loop: last KF revisits the first
    T_qc = jnp.asarray(T_true[-1] @ np.linalg.inv(T_true[0]))
    pg = build_pose_graph(m, jnp.int32(n_kfs - 1), jnp.int32(0), T_qc, cfg)
    pg = pg_ops.optimize(pg, iters=cfg.loop.pose_graph_iters)
    tr.map = correct_map(m, pg.T)

    rebuilt_ate = trajectory.ate_rmse(
        centers(slam.rebuilt_trajectory()), gt_c
    )
    # a single-loop pose-graph correction distributes the closure error
    # along the chain: the endpoint improves most (test_loopclosing asserts
    # >20% there), the full-trajectory RMSE by a clear margin.  The frozen
    # export cannot improve at all — that is the capability under test.
    assert rebuilt_ate < frozen_ate * 0.85, (
        f"loop correction did not reach the export: "
        f"frozen {frozen_ate:.4f} m vs rebuilt {rebuilt_ate:.4f} m"
    )
