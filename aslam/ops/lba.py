"""Local/global bundle adjustment: sparse Levenberg-Marquardt with
Schur-complement landmark elimination, built from batched array ops.

Replaces `LocalBundleAdjustment::Compute` (reference
localbundleadjustment.cpp:19-316) and `GlobalBundleAdjustment`
(globalbundleadjustment.cpp), which delegate to g2o's BlockSolver_6_3 with
marginalized landmark vertices (lba.cpp:131-137) and run the schedule
"5 iterations -> drop outlier edges (chi2 > 5.991/7.815 or depth <= 0) ->
10 iterations" (lba.cpp:212-255).

Batched formulation (SURVEY.md §7.2 step 7):
  * the problem is a pytree of fixed-capacity arrays (cams, points, a COO
    edge list) — no graph objects;
  * per-edge 3x6 / 3x3 Jacobian blocks are computed batched and reduced
    into per-camera 6x6, per-landmark 3x3, and camera-landmark 6x3 blocks
    by scatter-adds (`segment_sum`);
  * landmark elimination is the dense-blocked Schur complement
    S = Hcc - W Hll^-1 W^T computed as two matmuls over
    [6C, 3L] matrices; the reduced camera system is solved by Cholesky;
  * fixed cameras (the boundary observers, lba.cpp:51-63) keep identity
    rows in S so their update is exactly zero.

The same `assemble` kernel runs per-shard in the distributed version
(parallel/sharded_ba.py) with `psum` reductions over the edge axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import BAConfig, CameraModel
from aslam.ops.ba import huber_weight, project_residual_jac
from aslam.ops.linalg import chol_inv
from aslam.utils.se3 import se3_exp


class BAProblem(NamedTuple):
    """Fixed-capacity BA window."""

    cam_T: jnp.ndarray       # [C,4,4] world-to-camera poses
    cam_fixed: jnp.ndarray   # [C] bool: pose held constant (boundary KFs)
    cam_valid: jnp.ndarray   # [C] bool: slot in use
    points: jnp.ndarray      # [L,3] world landmark positions
    point_valid: jnp.ndarray # [L] bool
    e_cam: jnp.ndarray       # [E] int32 camera slot per edge
    e_lm: jnp.ndarray        # [E] int32 landmark slot per edge
    e_uv: jnp.ndarray        # [E,2] measured undistorted pixel
    e_ur: jnp.ndarray        # [E] measured right-u (<0 = mono edge)
    e_z: jnp.ndarray         # [E] measured keypoint depth (for info=1/z^2)
    e_valid: jnp.ndarray     # [E] bool


class BAStats(NamedTuple):
    chi2: jnp.ndarray        # scalar: total weighted squared error
    n_edges: jnp.ndarray     # scalar int32 active edges


class ChainSpec(NamedTuple):
    """Odometry-chain regularizer for the window: relative-pose edges
    between temporally consecutive window cameras, anchored at their
    relative transforms when the window was built.

    No reference counterpart — the g2o window re-solves poses against
    reprojection alone (localbundleadjustment.cpp:82-206).  Window
    landmarks carry correlated single-view depth noise; an unconstrained
    re-solve shears the keyframe chain to fit it (the r3 loop-scene
    diagnosis measured the rebuilt-from-KF trajectory LOSING to the live
    one for exactly this reason).  The chain edges keep the solution
    consistent with the tracked (odometry-prior-fused) relative motion
    unless reprojection evidence is persistent."""

    c_i: jnp.ndarray     # [P] int32 window-cam index
    c_j: jnp.ndarray     # [P] int32
    c_meas: jnp.ndarray  # [P,4,4] anchored T_i T_j^-1
    c_w: jnp.ndarray     # [P] float32 information (0 = inactive)


def map_chain(kf_T_cw: jnp.ndarray, kf_valid: jnp.ndarray,
              kf_id: jnp.ndarray, weight: float | jnp.ndarray) -> ChainSpec:
    """ChainSpec over temporally consecutive valid KFs of a WHOLE map,
    anchored at the given poses (used by post-loop global BA: the anchor
    is the pose-graph-corrected chain, which the joint refinement must
    respect while it re-solves points and poses)."""
    from aslam.utils.se3 import T_inv

    ids = jnp.where(kf_valid, kf_id, 2**30)
    order = jnp.argsort(ids).astype(jnp.int32)
    c_i = order[:-1]
    c_j = order[1:]
    both = (ids[c_i] < 2**30) & (ids[c_j] < 2**30)
    meas = kf_T_cw[c_i] @ T_inv(kf_T_cw[c_j])
    w = jnp.where(both, weight, 0.0)
    return ChainSpec(c_i=c_i, c_j=c_j, c_meas=meas, c_w=w)


def chain_terms(cam_T: jnp.ndarray, chain: ChainSpec):
    """Per-edge residuals/Jacobians of the chain regularizer; returns
    (H_off [C,C,6,6] scatter-ready blocks, b [C,6], chi2 scalar)."""
    from aslam.ops.pose_graph import _edge_jacobians, edge_residual

    C = cam_T.shape[0]
    T_i = cam_T[chain.c_i]
    T_j = cam_T[chain.c_j]
    r = jax.vmap(edge_residual)(T_i, T_j, chain.c_meas)        # [P,6]
    Ji, Jj = jax.vmap(_edge_jacobians)(T_i, T_j, chain.c_meas)  # [P,6,6]
    w = chain.c_w
    wJi = w[:, None, None] * Ji
    wJj = w[:, None, None] * Jj
    H = jnp.zeros((C, C, 6, 6))
    H = H.at[chain.c_i, chain.c_i].add(jnp.einsum("eri,erj->eij", wJi, Ji))
    H = H.at[chain.c_j, chain.c_j].add(jnp.einsum("eri,erj->eij", wJj, Jj))
    H = H.at[chain.c_i, chain.c_j].add(jnp.einsum("eri,erj->eij", wJi, Jj))
    H = H.at[chain.c_j, chain.c_i].add(jnp.einsum("eri,erj->eij", wJj, Ji))
    b = jnp.zeros((C, 6)).at[chain.c_i].add(
        jnp.einsum("eri,er->ei", wJi, r)
    ).at[chain.c_j].add(jnp.einsum("eri,er->ei", wJj, r))
    chi2 = jnp.sum(w * jnp.sum(r * r, axis=-1))
    return H, b, chi2


def edge_terms(prob: BAProblem, cam: CameraModel, cfg: BAConfig, robust: bool):
    """Batched per-edge residuals, Jacobians, weights, chi2."""
    T_e = prob.cam_T[prob.e_cam]               # [E,4,4]
    p_e = prob.points[prob.e_lm]               # [E,3]

    # vmapped single-edge version of the batched pose-BA kernel
    def one(T, p, uv, ur):
        r, Jc, Jp, depth_ok = project_residual_jac(
            T, p[None], uv[None], ur[None], cam
        )
        return r[0], Jc[0], Jp[0], depth_ok[0]

    r, Jc, Jp, depth_ok = jax.vmap(one)(T_e, p_e, prob.e_uv, prob.e_ur)

    is_stereo = prob.e_ur >= 0
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], -1
    )
    r = jnp.where(row_mask, r, 0.0)
    Jc = jnp.where(row_mask[..., None], Jc, 0.0)
    Jp = jnp.where(row_mask[..., None], Jp, 0.0)

    if cfg.info_model == "constant":
        # all valid edges weigh 1; mono (depth-less) observations still
        # constrain through their u,v rows (the stereo row is masked off
        # by row_mask above)
        info = jnp.ones_like(prob.e_z)
    else:  # "inv_z2" (reference semantics; z<=0 edges get weight 0)
        info = jnp.where(
            prob.e_z > 1e-3, 1.0 / jnp.maximum(prob.e_z, 1e-3) ** 2, 0.0)
    chi2 = jnp.sum(r * r, -1) * info
    chi2_th = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_huber = huber_weight(chi2, chi2_th) if robust else jnp.ones_like(chi2)

    active = (
        prob.e_valid
        & depth_ok
        & prob.cam_valid[prob.e_cam]
        & prob.point_valid[prob.e_lm]
    )
    w = info * w_huber * active
    return r, Jc, Jp, w, chi2, active


def edge_terms_grouped(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                       robust: bool, group: int):
    """`edge_terms` for camera-grouped problems — edge e belongs to camera
    e // group (the layout localmapping.build_problem emits:
    e_cam == repeat(arange(C), M)).  The pose "gather" becomes a broadcast
    and the Jacobian kernel runs batched per camera.  Returns
    [C,M,...]-shaped (r, Jc, Jp, w, chi2, active).

    Motivation: the grouped layout removes every [E]-indexed
    gather/scatter from the assembly."""
    C = prob.cam_T.shape[0]
    M = group
    lm = prob.e_lm.reshape(C, M)
    p_e = prob.points[lm]                           # [C,M,3] (true gather)
    uv = prob.e_uv.reshape(C, M, 2)
    ur = prob.e_ur.reshape(C, M)

    r, Jc, Jp, depth_ok = jax.vmap(
        lambda T, p, uv_, ur_: project_residual_jac(T, p, uv_, ur_, cam)
    )(prob.cam_T, p_e, uv, ur)                      # [C,M,3(,*)]

    is_stereo = ur >= 0
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], -1)
    r = jnp.where(row_mask, r, 0.0)
    Jc = jnp.where(row_mask[..., None], Jc, 0.0)
    Jp = jnp.where(row_mask[..., None], Jp, 0.0)

    e_z = prob.e_z.reshape(C, M)
    if cfg.info_model == "constant":
        info = jnp.ones_like(e_z)
    else:
        info = jnp.where(
            e_z > 1e-3, 1.0 / jnp.maximum(e_z, 1e-3) ** 2, 0.0)
    chi2 = jnp.sum(r * r, -1) * info
    chi2_th = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_huber = huber_weight(chi2, chi2_th) if robust else jnp.ones_like(chi2)

    active = (
        prob.e_valid.reshape(C, M)
        & depth_ok
        & prob.cam_valid[:, None]
        & prob.point_valid[lm]
    )
    w = info * w_huber * active
    return r, Jc, Jp, w, chi2, active


def _grouped_chunk(C: int) -> int:
    for b in (8, 4, 2):
        if C % b == 0:
            return b
    return 1


def assemble_grouped(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                     robust: bool, group: int):
    """`assemble` for camera-grouped problems: Hcc/bc are reshaped sums
    (no scatter), and the landmark-aligned terms (W, Hll, bl) are built by
    per-camera one-hot matmuls instead of a 32k-block scatter-add."""
    C = prob.cam_T.shape[0]
    M = group
    Lw = prob.points.shape[0]
    r, Jc, Jp, w, chi2, active = edge_terms_grouped(prob, cam, cfg, robust,
                                                    group)
    wJc = w[..., None, None] * Jc                   # [C,M,3,6]
    wJp = w[..., None, None] * Jp                   # [C,M,3,3]
    Hcc = jnp.einsum("cmri,cmrj->cij", wJc, Jc)
    bc = jnp.einsum("cmri,cmr->ci", wJc, r)

    V = jnp.concatenate([
        jnp.einsum("cmri,cmrj->cmij", wJc, Jp).reshape(C, M, 18),
        jnp.einsum("cmri,cmrj->cmij", wJp, Jp).reshape(C, M, 9),
        jnp.einsum("cmri,cmr->cmi", wJp, r),
    ], -1)                                          # [C,M,30]
    lm = prob.e_lm.reshape(C, M)

    B = _grouped_chunk(C)

    def chunk_body(acc, xs):
        lm_c, V_c = xs                              # [B,M], [B,M,30]
        oh = jax.nn.one_hot(lm_c, Lw, dtype=V.dtype)
        out = jnp.einsum("bml,bmv->blv", oh, V_c)   # [B,Lw,30]
        return acc + out[..., 18:].sum(0), out[..., :18]

    acc0 = jnp.zeros((Lw, 12), V.dtype)
    acc, W_chunks = jax.lax.scan(
        chunk_body, acc0,
        (lm.reshape(C // B, B, M), V.reshape(C // B, B, M, 30)))
    W = W_chunks.reshape(C, Lw, 6, 3)
    Hll = acc[:, :9].reshape(Lw, 3, 3)
    bl = acc[:, 9:]
    chi2_total = jnp.sum(jnp.where(active, chi2, 0.0))
    return Hcc, bc, Hll, bl, W, chi2_total


def assemble(prob: BAProblem, cam: CameraModel, cfg: BAConfig, robust: bool):
    """Build the block-sparse normal equations from the edge list.

    Returns (Hcc [C,6,6], bc [C,6], Hll [L,3,3], bl [L,3], W [C,L,6,3],
    chi2_total).  Pure segment reductions — runs identically per edge-shard
    in the distributed path (followed by psum).
    """
    C = prob.cam_T.shape[0]
    L = prob.points.shape[0]
    r, Jc, Jp, w, chi2, active = edge_terms(prob, cam, cfg, robust)

    wJc = w[:, None, None] * Jc                      # [E,3,6]
    Hcc = jnp.zeros((C, 6, 6)).at[prob.e_cam].add(
        jnp.einsum("eri,erj->eij", wJc, Jc)
    )
    bc = jnp.zeros((C, 6)).at[prob.e_cam].add(
        jnp.einsum("eri,er->ei", wJc, r)
    )
    wJp = w[:, None, None] * Jp                      # [E,3,3]
    Hll = jnp.zeros((L, 3, 3)).at[prob.e_lm].add(
        jnp.einsum("eri,erj->eij", wJp, Jp)
    )
    bl = jnp.zeros((L, 3)).at[prob.e_lm].add(
        jnp.einsum("eri,er->ei", wJp, r)
    )
    W = jnp.zeros((C, L, 6, 3)).at[prob.e_cam, prob.e_lm].add(
        jnp.einsum("eri,erj->eij", wJc, Jp)
    )
    chi2_total = jnp.sum(jnp.where(active, chi2, 0.0))
    return Hcc, bc, Hll, bl, W, chi2_total


def schur_solve(
    Hcc, bc, Hll, bl, W,
    cam_fixed: jnp.ndarray,
    point_valid: jnp.ndarray,
    lam: float,
    H_chain=None, b_chain=None,
):
    """Schur-complement solve: eliminate landmarks, solve cameras, back-
    substitute landmarks.  Returns (dxc [C,6], dxl [L,3]).

    H_chain/b_chain (optional) are camera-camera blocks from the odometry
    chain regularizer — they touch no landmarks, so they add to the
    reduced camera system AFTER elimination."""
    C, L = W.shape[0], W.shape[1]

    # LM damping
    eyes3 = jnp.broadcast_to(jnp.eye(3), Hll.shape)
    Hll_d = Hll + lam * eyes3 * jnp.maximum(
        jnp.trace(Hll, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    ) + 1e-8 * eyes3
    Hll_inv = chol_inv(Hll_d)                        # [L,3,3] batched

    # Y = W Hll^-1   [C,L,6,3] — einsum contracts the [L,3,3] factor
    # directly; an explicit broadcast_to materializes an 18 MB [C,L,3,3]
    # array for nothing
    Y = jnp.einsum("clij,ljk->clik", W, Hll_inv)

    # S = blockdiag(Hcc) - Y W^T as [C,6,C,6]; the single einsum lets XLA
    # fuse the layout changes into the matmul instead of paying two
    # explicit [C,L,6,3] transpose copies
    S = -jnp.einsum("clik,dljk->cidj", Y, W,
                    preferred_element_type=jnp.float32)
    S = S.at[jnp.arange(C), :, jnp.arange(C), :].add(Hcc)
    if H_chain is not None:
        S = S + H_chain.transpose(0, 2, 1, 3)
    S = S.reshape(C * 6, C * 6)
    rhs = (bc - jnp.einsum("clij,lj->ci", Y, bl))
    if b_chain is not None:
        rhs = rhs + b_chain
    rhs = rhs.reshape(C * 6)

    # damping + fixed-camera rows -> identity
    diag_scale = jnp.maximum(jnp.abs(jnp.diagonal(S)), 1e-6)
    S = S + jnp.diag(lam * diag_scale)
    fixed6 = jnp.repeat(cam_fixed, 6)
    S = jnp.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + jnp.diag(jnp.where(fixed6, 1.0, 0.0))
    rhs = jnp.where(fixed6, 0.0, rhs)

    dxc = -jnp.linalg.solve(S, rhs).reshape(C, 6)
    dxc = jnp.where(jnp.isfinite(dxc), dxc, 0.0)

    # back-substitute landmarks: dxl = -Hll^-1 (bl + W^T dxc)
    Wt_dxc = jnp.einsum("clij,ci->lj", W, dxc)
    dxl = -jnp.einsum("lij,lj->li", Hll_inv, bl + Wt_dxc)
    dxl = jnp.where(
        (point_valid[:, None]) & jnp.isfinite(dxl), dxl, 0.0
    )
    return dxc, dxl


def apply_update(prob: BAProblem, dxc: jnp.ndarray, dxl: jnp.ndarray) -> BAProblem:
    new_T = jax.vmap(se3_exp)(dxc) @ prob.cam_T
    new_T = jnp.where(prob.cam_fixed[:, None, None], prob.cam_T, new_T)
    new_pts = prob.points + dxl
    return prob._replace(cam_T=new_T, points=new_pts)


def ba_iterate(
    prob: BAProblem, cam: CameraModel, cfg: BAConfig,
    iters: int, robust: bool, lam: float = 1e-4,
    chain: ChainSpec | None = None,
    group: int | None = None,
) -> BAProblem:
    """Monotone Levenberg-Marquardt: a step that INCREASES chi2 is rejected
    and the damping raised (g2o's accept/reject schedule, which the
    reference delegates to — localbundleadjustment.cpp:66-74).  Costs one
    extra assemble per iteration; prevents divergent steps on
    ill-conditioned windows (ambiguous texture, marginal parallax)."""

    def chi2_and_chain(p):
        if chain is None:
            return None, None, 0.0
        return chain_terms(p.cam_T, chain)

    def full_assemble(p):
        if group is not None:
            Hcc, bc, Hll, bl, W, chi2 = assemble_grouped(
                p, cam, cfg, robust, group)
        else:
            Hcc, bc, Hll, bl, W, chi2 = assemble(p, cam, cfg, robust)
        H_ch, b_ch, chi2_ch = chi2_and_chain(p)
        return (Hcc, bc, Hll, bl, W, H_ch, b_ch), chi2 + chi2_ch

    # Single-assemble LM: the normal equations of the CURRENT accepted
    # iterate ride the carry, so each iteration assembles once (for the
    # candidate) instead of twice — exactly equivalent to the
    # assemble-twice monotone schedule because assemble() is pure (a
    # rejected step re-solves the carried H at higher damping, which is
    # the textbook LM retry).
    def body(_, carry):
        p, lam, H_p, chi2_p = carry
        Hcc, bc, Hll, bl, W, H_ch, b_ch = H_p
        dxc, dxl = schur_solve(Hcc, bc, Hll, bl, W, p.cam_fixed,
                               p.point_valid, lam,
                               H_chain=H_ch, b_chain=b_ch)
        p_new = apply_update(p, dxc, dxl)
        H_new, chi2_new = full_assemble(p_new)
        ok = chi2_new < chi2_p
        p = jax.tree.map(lambda a, b: jnp.where(ok, a, b), p_new, p)
        H_p = jax.tree.map(lambda a, b: jnp.where(ok, a, b), H_new, H_p)
        chi2_p = jnp.where(ok, chi2_new, chi2_p)
        lam = jnp.where(ok, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 8.0, 1e2))
        return (p, lam, H_p, chi2_p)

    H_0, chi2_0 = full_assemble(prob)
    p, _, _, _ = jax.lax.fori_loop(
        0, iters, body, (prob, jnp.asarray(lam), H_0, chi2_0))
    return p


def prune_outlier_edges(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                        group: int | None = None) -> BAProblem:
    """Drop edges with chi2 over threshold or nonpositive projected depth
    (lba.cpp:221-247)."""
    if group is not None:
        _, _, _, _, chi2, active = edge_terms_grouped(
            prob, cam, cfg, robust=False, group=group)
        chi2 = chi2.reshape(-1)
        active = active.reshape(-1)
    else:
        _, _, _, _, chi2, active = edge_terms(prob, cam, cfg, robust=False)
    is_stereo = prob.e_ur >= 0
    chi2_th = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    keep = active & (chi2 <= chi2_th)
    return prob._replace(e_valid=keep)


@functools.partial(jax.jit, static_argnames=("cam", "cfg", "group"))
def local_ba(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
             chain: ChainSpec | None = None, group: int | None = None):
    """Full local-BA schedule (lba.cpp:212-255): robust iterations, outlier
    pruning, then non-robust refinement.  Returns (problem, stats).

    `group` (static): edges-per-camera for camera-grouped problems
    (localmapping.build_problem layout) — enables the scatter-free
    assembly fast path (assemble_grouped)."""
    prob = ba_iterate(prob, cam, cfg, cfg.local_iters_1, robust=True,
                      chain=chain, group=group)
    prob = prune_outlier_edges(prob, cam, cfg, group=group)
    prob = ba_iterate(prob, cam, cfg, cfg.local_iters_2, robust=False,
                      chain=chain, group=group)
    if group is not None:
        _, _, _, _, chi2, active = edge_terms_grouped(
            prob, cam, cfg, robust=False, group=group)
    else:
        _, _, _, _, chi2, active = edge_terms(prob, cam, cfg, robust=False)
    stats = BAStats(
        chi2=jnp.sum(jnp.where(active, chi2, 0.0)),
        n_edges=jnp.sum(active.astype(jnp.int32)),
    )
    return prob, stats
