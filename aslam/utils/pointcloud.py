"""Dense point-cloud creation and export.

Replaces `Frame::CreateCloud` + voxel/statistical filtering (reference
frame.cpp:191-238, PCL `VoxelGrid`/`StatisticalOutlierRemoval`) and the
dense-map screenshots of the reference Results/: backproject a depth map,
thin it with the voxel hash, drop statistical outliers, transform to
world, and write a PLY any viewer opens.
"""

from __future__ import annotations

import numpy as np


def create_cloud(
    depth: np.ndarray,
    cam,
    T_cw: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
    stride: int = 2,
    voxel: float = 0.03,
):
    """Depth image [H,W] (meters) -> world-frame points [N,3] (+ gray
    values [N] if an intensity image is given)."""
    import jax.numpy as jnp

    from aslam.ops.icp import backproject_depth, voxel_downsample

    d = jnp.asarray(depth[::stride, ::stride])
    pts = np.asarray(backproject_depth(d, cam)).reshape(-1, 3)
    valid = np.asarray(d).reshape(-1) > 0.05
    if voxel > 0:
        _, keep = voxel_downsample(
            jnp.asarray(pts), jnp.asarray(valid), cell=voxel)
        valid = np.asarray(keep)
    pts = pts[valid]
    gray = None
    if intensity is not None:
        gray = intensity[::stride, ::stride].reshape(-1)[valid]
    if T_cw is not None:
        T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
        pts = pts @ T_wc[:3, :3].T + T_wc[:3, 3]
    return (pts.astype(np.float32), gray)


def statistical_outlier_filter(pts: np.ndarray, k: int = 16,
                               std_ratio: float = 1.0) -> np.ndarray:
    """SOR mask (frame.cpp:229-238 semantics): drop points whose mean
    k-NN distance exceeds mean + std_ratio * std.  O(N^2) chunked — meant
    for export-sized clouds, not the hot path."""
    n = len(pts)
    if n == 0:
        return np.zeros(0, bool)
    mean_d = np.empty(n, np.float32)
    chunk = 2048
    for s in range(0, n, chunk):
        d = np.linalg.norm(pts[s:s + chunk, None, :] - pts[None, :, :], axis=-1)
        part = np.partition(d, min(k, n - 1), axis=1)[:, 1:k + 1]
        mean_d[s:s + chunk] = part.mean(1)
    th = mean_d.mean() + std_ratio * mean_d.std()
    return mean_d <= th


def save_ply(path: str, pts: np.ndarray, gray: np.ndarray | None = None) -> None:
    """ASCII PLY writer (no external deps)."""
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if gray is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if gray is not None:
            g = np.clip(gray, 0, 255).astype(np.uint8)
            for p, c in zip(pts, g):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c} {c} {c}\n")
        else:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def export_dense_map(slam, seq, path: str, voxel: float = 0.03,
                     max_frames: int = 20) -> int:
    """Fuse frames from an indexable sequence of (timestamp, image, depth)
    with the estimated trajectory into one world cloud; returns point
    count.  Frame i of `seq` must correspond to pose i."""
    clouds, grays = [], []
    poses = slam.tracking.poses
    n = min(len(seq), len(poses))
    step = max(n // max_frames, 1)
    for i in range(0, n, step):
        t, img, depth = seq[i]
        pts, gray = create_cloud(depth, slam.cfg.camera, poses[i], img,
                                 voxel=voxel)
        clouds.append(pts)
        grays.append(gray)
    pts = np.concatenate(clouds) if clouds else np.zeros((0, 3), np.float32)
    gray = np.concatenate(grays) if clouds else None
    save_ply(path, pts, gray)
    return len(pts)
