"""Trajectory export + ATE/RPE evaluation.

Replaces `Tracking::SaveTrajectory` (reference tracking.cpp:544-607), which
writes TUM format `t x y z qx qy qz qw`, and brings the external TUM ATE
tooling in-repo (the reference evaluated accuracy outside the repository,
SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from aslam.utils import se3


def save_tum_trajectory(path: str, timestamps: np.ndarray, poses_cw: np.ndarray) -> None:
    """Write camera trajectory in TUM format.  Poses are world-to-camera
    `Tcw`; TUM wants camera-to-world `Twc` (tracking.cpp:569-578 inverts)."""
    with open(path, "w") as f:
        for t, T_cw in zip(timestamps, poses_cw):
            T_wc = np.asarray(se3.T_inv(np.asarray(T_cw, np.float32)))
            q = np.asarray(se3.R_to_quat(T_wc[:3, :3]))
            x, y, z = T_wc[:3, 3]
            f.write(
                f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def load_tum_trajectory(path: str):
    """Read TUM trajectory -> (timestamps [F], positions [F,3], quats [F,4])."""
    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def align_umeyama(est: np.ndarray, gt: np.ndarray):
    """Rigid (no-scale) alignment of estimated positions onto ground truth,
    the standard TUM ATE alignment."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g) / len(est)
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after rigid alignment (TUM metric)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        R, t = align_umeyama(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def ate_rmse_device(est_cw, gt_cw):
    """ATE RMSE computed ON DEVICE (jnp): rigid Umeyama alignment of the
    camera centers + RMSE, returning one scalar, so only the scalar
    crosses to the host."""
    import jax.numpy as jnp

    from aslam.utils import se3 as se3j

    est_centers = se3j.T_inv(est_cw)[..., :3, 3]
    gt_centers = se3j.T_inv(gt_cw)[..., :3, 3]
    mu_e = jnp.mean(est_centers, axis=0)
    mu_g = jnp.mean(gt_centers, axis=0)
    H = (est_centers - mu_e).T @ (gt_centers - mu_g) / est_centers.shape[0]
    U, _, Vt = jnp.linalg.svd(H)
    D = jnp.eye(3).at[2, 2].set(
        jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    )
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    aligned = est_centers @ R.T + t
    err = aligned - gt_centers
    return jnp.sqrt(jnp.mean(jnp.sum(err * err, axis=1)))


def rpe_rmse(est_cw: np.ndarray, gt_cw: np.ndarray, delta: int = 1):
    """Relative pose error RMSE (translation, rotation) over pose pairs."""
    est = np.asarray(est_cw, np.float64)
    gt = np.asarray(gt_cw, np.float64)
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        tr = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.arccos(tr))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs)))
    )
