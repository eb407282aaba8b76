"""Full-width configuration and seeded synthetic inputs that `bench.py`
and `chip_smoke.py` drive the engine with.

Full width is the TUM fr1 sensor at 640x480 (pinhole: the renderer draws
no lens distortion), 1000 ORB features in 1024 keypoint slots, 256 RANSAC
hypotheses, `MapConfig` defaults (256 keyframes, 32768 landmarks), a
32+32-camera local-BA window of 2048 points and 8192 edges on the 3+5
iteration schedule, and loop closing with the shipped vocabulary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from aslam import config
from aslam.config import BAConfig, CameraModel, SystemConfig
from aslam.utils import synthetic

TUM_FR1_PINHOLE = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                              width=640, height=480)


def full_config(cam: CameraModel = TUM_FR1_PINHOLE) -> SystemConfig:
    """The configuration `bench.py` times."""
    cfg = SystemConfig(camera=cam, use_loop_closing=True)
    return cfg.replace(
        ba=BAConfig(max_window_cams=32, max_fixed_cams=32,
                    max_window_points=2048, max_edges=8192,
                    local_iters_1=3, local_iters_2=5),
        map=dataclasses.replace(cfg.map, lm_cull_every=2, kf_cull_every=2,
                                lba_every=2, kf_cull_rounds=1),
        loop=dataclasses.replace(cfg.loop, use_pretrained_vocab=True),
    )


def small_config() -> SystemConfig:
    """`full_config`'s shape at unit-test capacity (320x240, 256 slots)."""
    cfg = config.small_config()
    return cfg.replace(
        use_loop_closing=True,
        loop=dataclasses.replace(cfg.loop, vocab_depth=4,
                                 use_pretrained_vocab=True),
    )


def to_sensor(imgs: np.ndarray, depths: np.ndarray, cam: CameraModel):
    """Float renders -> raw sensor dtypes (uint8 gray, uint16 depth counts),
    which the engine converts on device."""
    imgs_u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    deps_u16 = np.clip(depths / cam.depth_factor, 0, 65535).astype(np.uint16)
    return imgs_u8, deps_u16


def vo_sequence(cam: CameraModel, n_frames: int, seed: int = 5):
    """The VO cell's input: (uint8 [F,H,W], uint16 [F,H,W], T_cw [F,4,4])."""
    imgs, depths, poses, _ = synthetic.make_sequence(
        n_frames=n_frames, n_points=1500, cam=cam, seed=seed)
    return (*to_sensor(imgs, depths, cam), np.asarray(poses))


def slam_walk(cam: CameraModel, n_frames: int = 257, seed: int = 11):
    """The full-SLAM cell's input: a 2000-point room walked at 3 cm and
    0.012 rad per frame; same return layout as `vo_sequence`."""
    rng = np.random.default_rng(seed)
    pts = synthetic.random_scene(rng, 2000)
    poses = synthetic.camera_trajectory(n_frames, step_t=0.03,
                                        step_r=0.012, rng=rng)
    tex = synthetic.point_textures(2000, seed=seed + 1)
    imgs = np.stack([synthetic.render_intensity_image(cam, T, pts, tex)
                     for T in poses])
    deps = np.stack([synthetic.render_depth_image(cam, T, pts, splat=4)
                     for T in poses])
    return (*to_sensor(imgs, deps, cam), poses)


def centers(poses_cw: np.ndarray) -> np.ndarray:
    """Camera centres [F,3] of world-to-camera poses [F,4,4]."""
    poses_cw = np.asarray(poses_cw, np.float64)
    R, t = poses_cw[:, :3, :3], poses_cw[:, :3, 3]
    return -np.einsum("fji,fj->fi", R, t)


def slam_pass(cfg: SystemConfig, imgs: np.ndarray, deps: np.ndarray,
              chunk: int = 64, seed: int = 0):
    """`DeviceSlam` over a sequence as the full-SLAM cell runs it: bootstrap
    on frame 0, then chunks of `chunk` frames (one compiled scan length),
    each chunk's upload overlapping the previous chunk's work.  Returns
    the engine once its state is computed."""
    import jax

    from aslam.models.device_slam import DeviceSlam

    dev = DeviceSlam(cfg, seed=seed, sync_every=2 * chunk)
    dev.process(imgs[0], deps[0], 0.0)
    starts = list(range(1, len(imgs), chunk))

    def put(lo):
        return (jax.device_put(imgs[lo:lo + chunk]),
                jax.device_put(deps[lo:lo + chunk]))

    buf = put(starts[0])
    for i, lo in enumerate(starts):
        im, dp = buf
        if i + 1 < len(starts):
            buf = put(starts[i + 1])
        dev.process_chunk(im, dp, ts=[0.033 * (lo + j) for j in range(len(im))])
    jax.block_until_ready(dev.state)
    return dev


def build_corridor_map(cfg, n_kfs: int, n_feats: int, seed: int = 0):
    """Vectorized large-map construction: KF k at x = 0.05k looking down
    +z; landmarks on a 3D strip; KF k observes a contiguous landmark
    window (realistic covisibility banding)."""
    import jax.numpy as jnp

    from aslam.models import mapstate as ms

    rng = np.random.default_rng(seed)
    cam = cfg.camera
    step = 0.05
    lm_per_kf = max(n_feats // 4, 1)          # window shift per KF
    L = n_kfs * lm_per_kf + n_feats

    # landmarks: strip along x, lateral scatter, 2-4 m ahead
    lx = np.arange(L) * (step / lm_per_kf)
    lm_pos = np.stack([
        lx + rng.uniform(-0.5, 0.5, L),
        rng.uniform(-1.0, 1.0, L),
        rng.uniform(2.0, 4.0, L),
    ], -1).astype(np.float32)

    kf_x = np.arange(n_kfs, dtype=np.float32) * step
    T = np.tile(np.eye(4, dtype=np.float32), (n_kfs, 1, 1))
    T[:, 0, 3] = -kf_x                         # camera at world x

    # observation windows: KF k sees landmarks [k*lm_per_kf, +n_feats)
    base = (np.arange(n_kfs)[:, None] * lm_per_kf
            + np.arange(n_feats)[None, :])    # [K, M]
    pts = lm_pos[base]                         # [K, M, 3]
    pc = pts.copy()
    pc[..., 0] -= kf_x[:, None]
    z = pc[..., 2]
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    u += rng.normal(0, 0.3, u.shape).astype(np.float32)
    v += rng.normal(0, 0.3, v.shape).astype(np.float32)
    valid = (u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
    ur = np.where(z > 0, u - cam.bf / z, -1.0)

    m = ms.init_map(cfg)
    # resize map arrays to this scale (BA-only fields; descriptors stay
    # minimal)
    m = m._replace(
        kf_T_cw=jnp.asarray(T),
        kf_valid=jnp.ones(n_kfs, bool),
        kf_id=jnp.arange(n_kfs, dtype=jnp.int32),
        kf_xy=jnp.asarray(np.stack([u, v], -1).astype(np.float32)),
        kf_ur=jnp.asarray(ur.astype(np.float32)),
        kf_z=jnp.asarray(z.astype(np.float32)),
        kf_desc=jnp.zeros((n_kfs, n_feats, 8), jnp.uint32),
        kf_octave=jnp.zeros((n_kfs, n_feats), jnp.int32),
        kf_kp_valid=jnp.asarray(valid),
        kf_lm=jnp.asarray(base.astype(np.int32)),
        lm_pos=jnp.asarray(
            lm_pos + rng.normal(0, 0.02, lm_pos.shape).astype(np.float32)),
        lm_desc=jnp.zeros((L, 8), jnp.uint32),
        lm_valid=jnp.ones(L, bool),
        lm_first_kf=jnp.zeros(L, jnp.int32),
        lm_visible=jnp.ones(L, jnp.int32),
        lm_found=jnp.ones(L, jnp.int32),
        **_observer_index(base, valid, L, n_kfs),
    )
    return m, T, lm_pos


def _observer_index(base, valid, L, n_kfs, O=16):
    """Vectorized observer reverse index for the banded corridor map."""
    import jax.numpy as jnp

    okf = np.full((L, O), -1, np.int32)
    ofe = np.zeros((L, O), np.int32)
    ptr = np.zeros(L, np.int32)
    feats = np.arange(base.shape[1], dtype=np.int32)
    for k in range(n_kfs):
        ls = base[k][valid[k]]
        fs = feats[valid[k]]
        pos = ptr[ls] % O
        okf[ls, pos] = k
        ofe[ls, pos] = fs
        ptr[ls] += 1
    return dict(lm_obs_kf=jnp.asarray(okf), lm_obs_feat=jnp.asarray(ofe),
                lm_obs_ptr=jnp.asarray(ptr))
