"""ICP refinement: normals, projective point-to-plane alignment, voxel
thinning, adaptive RICP escalation policy."""

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import CameraModel, ICPConfig, small_config
from aslam.ops import icp
from aslam.utils import se3, synthetic

CAM = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)


def wavy_depth(h=240, w=320):
    """Smooth non-planar depth surface (plane + gentle waves) so
    point-to-plane has full 6-dof constraints."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    return (
        2.0
        + 0.25 * np.sin(u / 37.0) + 0.2 * np.cos(v / 23.0)
        + 0.001 * u * 0.3 + 0.0008 * v * 0.2
    ).astype(np.float32)


def test_normal_map_plane():
    """Flat fronto-parallel depth -> normals ~ (0,0,-1) toward camera."""
    depth = jnp.full((64, 64), 2.0)
    pts = icp.backproject_depth(depth, CAM)
    n = np.asarray(icp.normal_map(pts, np.ones((64, 64), bool)))
    inner = n[10:-10, 10:-10]
    assert np.allclose(np.abs(inner[..., 2]), 1.0, atol=0.05)


def test_icp_recovers_small_transform(rng):
    depth = wavy_depth()
    pts_img = np.asarray(icp.backproject_depth(jnp.asarray(depth), CAM))
    # source points: subsample target surface, moved by T12^-1 (so that
    # T12 * src = target)
    sel_v = rng.integers(10, 230, 400)
    sel_u = rng.integers(10, 310, 400)
    tgt_pts = pts_img[sel_v, sel_u]
    xi = np.array([0.01, -0.015, 0.02, 0.004, -0.006, 0.005], np.float32)
    T12_true = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    src = (tgt_pts - T12_true[:3, 3]) @ T12_true[:3, :3]  # inv transform

    res = icp.icp_refine(
        jnp.asarray(src), jnp.ones(400, bool), jnp.asarray(depth),
        jnp.eye(4), CAM, ICPConfig(iterations=15),
    )
    assert bool(res.converged)
    T = np.asarray(res.T12)
    dt = np.linalg.norm(T[:3, 3] - T12_true[:3, 3])
    dr = float(np.asarray(se3.rotation_angle(
        jnp.asarray(T[:3, :3] @ T12_true[:3, :3].T))))
    assert dt < 0.005, f"translation error {dt}"
    assert dr < 0.005, f"rotation error {dr}"
    assert float(res.rmse) < 0.01


def test_icp_identity_on_aligned(rng):
    depth = wavy_depth()
    pts_img = np.asarray(icp.backproject_depth(jnp.asarray(depth), CAM))
    src = pts_img[rng.integers(10, 230, 200), rng.integers(10, 310, 200)]
    res = icp.icp_refine(
        jnp.asarray(src), jnp.ones(200, bool), jnp.asarray(depth),
        jnp.eye(4), CAM, ICPConfig(iterations=8),
    )
    T = np.asarray(res.T12)
    assert np.linalg.norm(T[:3, 3]) < 1e-3
    assert float(res.rmse) < 1e-3


def test_voxel_downsample(rng):
    pts = rng.uniform(0, 1.0, (500, 3)).astype(np.float32)
    _, keep = icp.voxel_downsample(jnp.asarray(pts), jnp.ones(500, bool),
                                   cell=0.25)
    keep = np.asarray(keep)
    # at most one point per voxel
    kept = pts[keep]
    vox = np.floor(kept / 0.25).astype(int)
    uniq = np.unique(vox, axis=0)
    assert len(uniq) == len(kept)
    # every occupied voxel keeps a representative
    all_vox = np.unique(np.floor(pts / 0.25).astype(int), axis=0)
    assert len(uniq) == len(all_vox)


def test_ricp_policy_runs_in_system():
    """Full system with the ADAPTIVE_RICP odometry policy still tracks."""
    from aslam.models.system import SlamSystem

    cfg = small_config().replace(use_gicp=True)
    imgs, depths, poses_gt, _ = synthetic.make_sequence(
        n_frames=4, n_points=400, cam=cfg.camera, seed=9
    )
    slam = SlamSystem(cfg)
    for i in range(4):
        T, info = slam.process(imgs[i], depths[i], t=i * 0.03)
    # tracked with sane pose magnitudes (steps are ~2 cm)
    d = np.linalg.norm(np.asarray(T)[:3, 3])
    assert d < 0.5


def test_ricp_escalates_on_poor_ransac(rng):
    """Force the escalation branch (odometry.cpp:52-66): frames with valid
    depth maps but almost no depth-valid keypoint matches make RANSAC fail
    (ok=False, 0 inliers), so the policy must fall to ICP, which succeeds
    off the dense depth."""
    import jax

    from aslam.config import small_config
    from aslam.models.extractor import Features
    from aslam.models.frame import FrameData
    from aslam.models.odometry import ricp_step

    cfg = small_config().replace(use_gicp=True)
    cam = cfg.camera
    M = cfg.extractor.max_keypoints
    depth = wavy_depth(cam.height, cam.width)

    def mk_frame(desc, kp_depth_valid):
        xy = jnp.asarray(rng.uniform(20, 300, (M, 2)).astype(np.float32))
        z = jnp.asarray(rng.uniform(0.5, 3.0, M).astype(np.float32))
        z = jnp.where(jnp.asarray(kp_depth_valid), z, 0.0)
        feat = Features(
            xy=xy, response=jnp.ones(M), angle=jnp.zeros(M),
            octave=jnp.zeros(M, jnp.int32), desc=jnp.asarray(desc),
            valid=jnp.ones(M, bool),
        )
        from aslam.utils import camera as cam_mod

        return FrameData(
            feat=feat, xy_und=xy, p3d=cam_mod.unproject(cam, xy, z),
            ur=jnp.full(M, -1.0), depth=z, has_depth=z > 0,
            T_cw=jnp.eye(4), depth_map=jnp.asarray(depth),
        )

    desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    # matching descriptors but NO overlapping depth validity -> RANSAC
    # has zero valid pairs
    v1 = np.zeros(M, bool); v1[: M // 2] = True
    v2 = ~v1
    f1 = mk_frame(desc, v1)
    f2 = mk_frame(desc, v2)
    res = ricp_step(f1, f2, jax.random.PRNGKey(0), cfg)
    # RANSAC had nothing (0 valid pairs) so the policy escalated; with no
    # valid ICP source points either, the identity fallback must engage
    # (odometry.cpp:55-65) and the output stays finite and sane
    T = np.asarray(res.T_cw2)
    assert np.isfinite(T).all()
    assert np.linalg.norm(T[:3, 3]) < 0.05
    assert int(res.n_inliers) < cfg.icp.escalate_min_inliers
