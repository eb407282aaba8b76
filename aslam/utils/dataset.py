"""Dataset loading: TUM RGB-D association files + image decode.

Replaces `Utils/utils.cpp:16-38` (LoadImages) and the cv::imread calls in the
reference driver (main.cpp:94-95).  Image decode prefers the native C++
loader (aslam.native, zlib-based PNG inflate) when it is built, and
otherwise uses the NumPy + stdlib-zlib decoder (aslam.utils.png).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from aslam.utils import png


@dataclass
class TumAssociations:
    timestamps: np.ndarray        # [F] float64
    rgb_paths: list[str]
    depth_paths: list[str]


def load_associations(dataset_dir: str, filename: str = "associations.txt") -> TumAssociations:
    """Parse a TUM association file: `t_rgb rgb_path t_depth depth_path`
    per line (reference utils.cpp:16-38)."""
    path = os.path.join(dataset_dir, filename)
    ts, rgbs, depths = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgbs.append(os.path.join(dataset_dir, parts[1]))
            depths.append(os.path.join(dataset_dir, parts[3]))
    return TumAssociations(np.asarray(ts, np.float64), rgbs, depths)


def associate(rgb_list: list[tuple[float, str]], depth_list: list[tuple[float, str]],
              max_dt: float = 0.02) -> list[tuple[float, str, str]]:
    """Greedy nearest-timestamp association of rgb.txt/depth.txt entries, for
    datasets shipping without a pre-built associations.txt (same contract as
    the TUM associate.py tooling the reference pipeline assumes ran already)."""
    out = []
    j = 0
    for t, rgb in rgb_list:
        # advance depth pointer to nearest timestamp
        while j + 1 < len(depth_list) and abs(depth_list[j + 1][0] - t) <= abs(depth_list[j][0] - t):
            j += 1
        if abs(depth_list[j][0] - t) <= max_dt:
            out.append((t, rgb, depth_list[j][1]))
    return out


def _decode(path: str) -> np.ndarray:
    """Native decoder when built, else the stdlib-zlib one."""
    from aslam.native import loader as native_loader

    img = native_loader.decode_png(path)
    return png.read_png(path) if img is None else img


def load_rgb_gray(path: str) -> np.ndarray:
    """Load an RGB image as float32 grayscale [H,W] in [0,255]
    (reference frame.cpp:18-31: BGR -> gray)."""
    img = _decode(path)
    if img.ndim == 3:
        img = (
            0.299 * img[..., 0].astype(np.float32)
            + 0.587 * img[..., 1].astype(np.float32)
            + 0.114 * img[..., 2].astype(np.float32)
        )
    return img.astype(np.float32)


def load_depth(path: str, depth_factor: float = 1.0 / 5000.0) -> np.ndarray:
    """Load a 16-bit depth PNG as float32 meters (frame.cpp:33-45:
    depth * 1/5000)."""
    return _decode(path).astype(np.float32) * depth_factor


def write_tum_sequence(out_dir: str, imgs_u8: np.ndarray,
                       depths_u16: np.ndarray, poses_cw: np.ndarray,
                       t0: float = 1305031102.175304, fps: float = 30.0):
    """Write a TUM-layout sequence: 3-channel 8-bit `rgb/*.png`, 16-bit
    `depth/*.png` counts, `associations.txt` and `groundtruth.txt`
    (camera-to-world poses).  NumPy only: it starts no accelerator
    client, so the CLI can run on the card in a child process.  Returns
    the timestamps."""
    from scipy.spatial.transform import Rotation

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    ts = t0 + np.arange(len(imgs_u8)) / fps
    lines = []
    for t, gray, counts in zip(ts, imgs_u8, depths_u16):
        name = f"{t:.6f}.png"
        png.write_png(os.path.join(out_dir, "rgb", name),
                      np.repeat(gray[..., None], 3, axis=-1))
        png.write_png(os.path.join(out_dir, "depth", name), counts)
        lines.append(f"{t:.6f} rgb/{name} {t:.6f} depth/{name}")
    with open(os.path.join(out_dir, "associations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    T_wc = np.linalg.inv(np.asarray(poses_cw, np.float64))
    quats = Rotation.from_matrix(T_wc[:, :3, :3]).as_quat()   # x y z w
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, T, q in zip(ts, T_wc, quats):
            f.write(f"{t:.6f} " + " ".join(f"{v:.6f}" for v in T[:3, 3])
                    + " " + " ".join(f"{v:.6f}" for v in q) + "\n")
    return ts


class TumSequence:
    """Iterable RGB-D sequence with background prefetch.

    The reference decodes synchronously inside the frame loop
    (main.cpp:94-95).  Here decode runs ahead on a thread pool: the native
    C++ decoder releases the GIL for the duration of each ctypes call, so
    `lookahead` frames decode in parallel with device compute.
    """

    def __init__(self, dataset_dir: str, depth_factor: float = 1.0 / 5000.0,
                 association_file: str = "associations.txt",
                 lookahead: int = 4, workers: int = 2):
        self.assoc = load_associations(dataset_dir, association_file)
        self.depth_factor = depth_factor
        self.lookahead = lookahead
        self._pool = None
        self._native = None
        self._futures: dict[int, object] = {}
        if lookahead > 0:
            # prefer the fully-native pipeline (C++ worker threads + ring,
            # native/prefetcher.cpp) — zero Python threads in the loop
            from aslam.native.loader import NativePrefetcher

            self._native = NativePrefetcher.create(
                self.assoc.rgb_paths, self.assoc.depth_paths,
                lookahead=lookahead, workers=workers)
        if lookahead > 0 and self._native is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self) -> int:
        return len(self.assoc.rgb_paths)

    def _load(self, i: int):
        return (
            self.assoc.timestamps[i],
            load_rgb_gray(self.assoc.rgb_paths[i]),
            load_depth(self.assoc.depth_paths[i], self.depth_factor),
        )

    def __getitem__(self, i: int):
        if self._native is not None:
            pair = self._native.get(i)
            if pair is not None:
                rgb, depth = pair
                if rgb.ndim == 3:
                    rgb = (0.299 * rgb[..., 0].astype(np.float32)
                           + 0.587 * rgb[..., 1].astype(np.float32)
                           + 0.114 * rgb[..., 2].astype(np.float32))
                return (self.assoc.timestamps[i], rgb.astype(np.float32),
                        depth.astype(np.float32) * self.depth_factor)
            return self._load(i)  # decode failure -> Python fallback
        if self._pool is None:
            return self._load(i)
        # schedule lookahead window, collect this frame
        for j in range(i, min(i + 1 + self.lookahead, len(self))):
            if j not in self._futures:
                self._futures[j] = self._pool.submit(self._load, j)
        fut = self._futures.pop(i, None)
        if fut is None:
            return self._load(i)
        return fut.result()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._native is not None:
            self._native.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
