"""Frame-to-frame odometry policy.

Replaces `Odometry::Compute` (reference odometry.cpp:44-117).  The policy
used by the reference driver is ADAPTIVE_RBA (main.cpp:23): Mahalanobis
RANSAC for an initial T12, pose composition T_cw2 = T12 * T_cw1, then
motion-only BA refinement.  ADAPTIVE_RICP escalates to GICP instead when
RANSAC quality is poor (inliers < 20 or rmse*10 >= 7, odometry.cpp:52-66).

Everything below the policy branch is one jitted computation; the escalation
decision reads two scalars on the host (matching the reference's
data-dependent branch, which cannot live inside jit — SURVEY.md §7.3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import SystemConfig
from aslam.models.frame import FrameData
from aslam.ops import ba, matching, ransac
from aslam.utils.se3 import T_inv, transform_points


class OdometryResult(NamedTuple):
    T_cw2: jnp.ndarray       # [4,4] estimated pose of frame 2
    T12: jnp.ndarray         # [4,4] relative cam1->cam2
    match_idx: jnp.ndarray   # [M] feature index in frame2 per frame1 feature
    inliers: jnp.ndarray     # [M] bool over frame-1 features
    n_matches: jnp.ndarray   # scalar int32
    n_inliers: jnp.ndarray   # scalar int32
    rmse: jnp.ndarray        # scalar float32 (RANSAC residual)
    ba_inliers: jnp.ndarray  # scalar int32 (motion-only BA inlier count)


@functools.partial(jax.jit, static_argnames=("cfg",))
def ransac_step(
    f1: FrameData,
    f2: FrameData,
    key: jnp.ndarray,
    cfg: SystemConfig,
):
    """Match + RANSAC only (the shared first stage of every policy).
    Returns (T12, match Matches, pair_valid, RansacResult)."""
    m = matching.knn_ratio_match(
        f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high),
    )
    m = matching.resolve_duplicates(m, f2.feat.desc.shape[0])
    tgt = jnp.maximum(m.target_idx, 0)
    p1 = f1.p3d
    p2 = f2.p3d[tgt]
    pair_valid = m.valid & f1.has_depth & f2.has_depth[tgt]
    res = ransac.ransac_align(p1, p2, pair_valid, key, cfg.ransac, cfg.camera)
    return m, pair_valid, res


@functools.partial(jax.jit, static_argnames=("cfg", "warm_from_ransac"))
def _icp_refine_step(
    f1: FrameData,
    f2: FrameData,
    pair_valid: jnp.ndarray,
    T_ransac: jnp.ndarray,
    cfg: SystemConfig,
    warm_from_ransac: bool,
):
    from aslam.ops import icp

    cam = cfg.camera
    T_init = T_ransac if warm_from_ransac else jnp.eye(4)
    src_valid = f1.has_depth & pair_valid
    if cfg.icp.method == "gicp":
        nm = icp.normal_map(
            icp.backproject_depth(f1.depth_map, cam), f1.depth_map > 0.05)
        H, W = f1.depth_map.shape
        xi = jnp.clip(jnp.round(f1.feat.xy[:, 0]).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.round(f1.feat.xy[:, 1]).astype(jnp.int32), 0, H - 1)
        return icp.gicp_refine(
            f1.p3d, nm[yi, xi], src_valid, f2.depth_map, T_init, cam, cfg.icp)
    return icp.icp_refine(
        f1.p3d, src_valid, f2.depth_map, T_init, cam, cfg.icp,
    )


def ricp_step(
    f1: FrameData,
    f2: FrameData,
    key: jnp.ndarray,
    cfg: SystemConfig,
) -> OdometryResult:
    """ADAPTIVE_RICP policy (odometry.cpp:46-78): RANSAC, then escalate to
    ICP when inliers < 20 or rmse*10 >= 7; ICP warm-starts from the RANSAC
    transform unless rmse*10 >= 20 (then identity).  The escalation branch
    reads two scalars on the host, mirroring the reference's CPU branch."""
    m, pair_valid, res = ransac_step(f1, f2, key, cfg)
    n_inl = int(res.n_inliers)
    rmse = float(res.rmse)
    T12 = res.T12
    if (n_inl < cfg.icp.escalate_min_inliers
            or rmse * 10.0 >= cfg.icp.escalate_rmse * 10.0):
        warm = rmse * 10.0 < cfg.icp.restart_rmse * 10.0
        icp_res = _icp_refine_step(f1, f2, pair_valid, res.T12, cfg,
                                   warm_from_ransac=warm)
        if bool(icp_res.converged):
            T12 = icp_res.T12
        elif not warm:
            T12 = jnp.eye(4)
    T_cw2 = T12 @ f1.T_cw
    return OdometryResult(
        T_cw2=T_cw2,
        T12=T12,
        match_idx=m.target_idx,
        inliers=res.inliers,
        n_matches=jnp.sum(m.valid.astype(jnp.int32)),
        n_inliers=res.n_inliers,
        rmse=res.rmse,
        ba_inliers=jnp.int32(0),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def ricp_fused(
    f1: FrameData,
    f2: FrameData,
    key: jnp.ndarray,
    cfg: SystemConfig,
) -> OdometryResult:
    """ADAPTIVE_RICP as ONE device program: RANSAC, then — under
    `lax.cond`, so only the taken branch executes — GICP refinement when
    RANSAC quality is poor (inliers < 20 or rmse*10 >= 7; warm start from
    the RANSAC transform unless rmse*10 >= 20, odometry.cpp:46-78).

    Unlike the host-branch `ricp_step`, no scalar crosses to the host, so
    the `slam+gicp` configuration keeps the engine's one-dispatch-per-frame
    property (the escalation predicate is evaluated on device)."""
    from aslam.ops import icp

    cam = cfg.camera
    m, pair_valid, res = ransac_step(f1, f2, key, cfg)

    escalate = (res.n_inliers < cfg.icp.escalate_min_inliers) | (
        res.rmse * 10.0 >= cfg.icp.escalate_rmse * 10.0
    )
    warm = res.rmse * 10.0 < cfg.icp.restart_rmse * 10.0
    fallback = jnp.where(warm, res.T12, jnp.eye(4))

    def refine(_):
        T_init = fallback
        src_valid = f1.has_depth & pair_valid
        if cfg.icp.method == "gicp":
            nm = icp.normal_map(
                icp.backproject_depth(f1.depth_map, cam),
                f1.depth_map > 0.05,
            )
            H, W = f1.depth_map.shape
            xi = jnp.clip(jnp.round(f1.feat.xy[:, 0]).astype(jnp.int32),
                          0, W - 1)
            yi = jnp.clip(jnp.round(f1.feat.xy[:, 1]).astype(jnp.int32),
                          0, H - 1)
            src_n = nm[yi, xi]
            icp_res = icp.gicp_refine(
                f1.p3d, src_n, src_valid, f2.depth_map, T_init, cam, cfg.icp)
        else:
            icp_res = icp.icp_refine(
                f1.p3d, src_valid, f2.depth_map, T_init, cam, cfg.icp)
        return jnp.where(icp_res.converged, icp_res.T12, fallback)

    T12 = jax.lax.cond(escalate, refine, lambda _: res.T12, None)
    T_cw2 = T12 @ f1.T_cw
    return OdometryResult(
        T_cw2=T_cw2,
        T12=T12,
        match_idx=m.target_idx,
        inliers=res.inliers,
        n_matches=jnp.sum(m.valid.astype(jnp.int32)),
        n_inliers=res.n_inliers,
        rmse=res.rmse,
        ba_inliers=jnp.int32(0),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def rba_step(
    f1: FrameData,
    f2: FrameData,
    key: jnp.ndarray,
    cfg: SystemConfig,
) -> OdometryResult:
    """RANSAC + motion-only BA refinement (ADAPTIVE_RBA,
    odometry.cpp:105-116), fully on device."""
    cam = cfg.camera

    # 1. knn ratio match frame1 -> frame2 (tracking.cpp:199, ratio 0.9)
    m = matching.knn_ratio_match(
        f1.feat.desc, f1.feat.valid, f2.feat.desc, f2.feat.valid,
        ratio=cfg.matcher.ratio_frame, max_dist=float(cfg.matcher.th_high),
    )
    m = matching.resolve_duplicates(m, f2.feat.desc.shape[0])
    tgt = jnp.maximum(m.target_idx, 0)

    # 2. 3D-3D RANSAC over matched pairs with valid depth (ransac.cpp)
    p1 = f1.p3d
    p2 = f2.p3d[tgt]
    pair_valid = m.valid & f1.has_depth & f2.has_depth[tgt]
    res = ransac.ransac_align(p1, p2, pair_valid, key, cfg.ransac, cam)

    # 3. compose (odometry.cpp:111: T2w = T12 * T1w)
    T_cw2_init = res.T12 @ f1.T_cw

    # 4. motion-only BA on the RANSAC inliers: world points from frame1
    #    depth, observations from frame2 keypoints (pnpsolver.cpp semantics)
    pts_w = transform_points(T_inv(f1.T_cw), p1)
    obs_uv = f2.xy_und[tgt]
    obs_ur = f2.ur[tgt]
    obs_z = f2.depth[tgt]
    ba_res = ba.pose_only_ba(
        T_cw2_init, pts_w, obs_uv, obs_ur, obs_z,
        res.inliers & pair_valid, cam, cfg.ba,
    )
    # use the BA pose when it kept enough inliers, else RANSAC's
    use_ba = ba_res.n_inliers >= cfg.ransac.min_inliers
    T_cw2 = jnp.where(use_ba, ba_res.T_cw, T_cw2_init)

    return OdometryResult(
        T_cw2=T_cw2,
        T12=T_cw2 @ T_inv(f1.T_cw),
        match_idx=m.target_idx,
        inliers=res.inliers,
        n_matches=jnp.sum(m.valid.astype(jnp.int32)),
        n_inliers=res.n_inliers,
        rmse=res.rmse,
        ba_inliers=ba_res.n_inliers,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def track_frame(
    prev: FrameData,
    img: jnp.ndarray,
    depth_map: jnp.ndarray,
    grid_thresholds: jnp.ndarray,
    key: jnp.ndarray,
    cfg: SystemConfig,
    height: int,
    width: int,
):
    """Fused per-frame VO step: extraction + ADAPTIVE_RBA odometry as ONE
    device program -> (posed FrameData, new grid thresholds, OdometryResult).

    Halves the dispatches per frame vs make_frame + rba_step: the fusion
    saves one host round-trip and lets XLA overlap extraction with the
    matching of the previous stage.
    """
    from aslam.models import frame as frame_mod

    f, new_grid = frame_mod._make_frame_impl(
        img, depth_map, grid_thresholds, cfg, height, width)
    res = rba_step(prev, f, key, cfg)
    return f._replace(T_cw=res.T_cw2), new_grid, res


class SequenceResult(NamedTuple):
    T_cw: jnp.ndarray        # [T,4,4] estimated pose per frame
    n_matches: jnp.ndarray   # [T] int32
    n_inliers: jnp.ndarray   # [T] int32
    rmse: jnp.ndarray        # [T] float32


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def track_sequence(
    prev: FrameData,
    imgs: jnp.ndarray,       # [T,H,W] uint8 (or float gray)
    depths: jnp.ndarray,     # [T,H,W] uint16 counts (or float metres)
    grid_thresholds: jnp.ndarray,
    keys: jnp.ndarray,       # [T,2] PRNG keys
    cfg: SystemConfig,
    height: int,
    width: int,
):
    """Chained multi-frame VO: `lax.scan` of `track_frame` over a frame
    chunk — ONE device program (one dispatch) for the whole chunk.

    Chaining T frames per dispatch amortizes the per-dispatch host cost
    T-fold.  Exactly equivalent to calling
    `track_frame` frame-by-frame (same carry: previous FrameData +
    adaptive grid thresholds) — the streaming path stays available for
    sensor-driven real-time use; this is the recorded-sequence / serving
    path (the reference driver also consumes a recorded dataset,
    main.cpp:93-102).

    Returns (last FrameData, final grid thresholds, SequenceResult).
    """

    def step(carry, xs):
        prev_f, grid = carry
        img, depth, key = xs
        f, new_grid, res = track_frame(
            prev_f, img, depth, grid, key, cfg, height, width)
        out = SequenceResult(T_cw=res.T_cw2, n_matches=res.n_matches,
                             n_inliers=res.n_inliers, rmse=res.rmse)
        return (f, new_grid), out

    (last, grid), ys = jax.lax.scan(
        step, (prev, grid_thresholds), (imgs, depths, keys))
    return last, grid, ys
