"""Global bundle adjustment over the whole map.

Replaces `GlobalBundleAdjustment::Compute` (reference
globalbundleadjustment.cpp:18-191 — g2o LM over all KFs/landmarks, info =
identity, optional robust kernel; never called from the live pipeline).

Design: at map scale the dense-blocked Schur complement of
ops/lba.py would materialize a [C, L, 6, 3] coupling tensor (gigabytes at
256 KFs x 32k landmarks), so global BA instead uses **alternating
resection-intersection sweeps** (the first-order BA family, cf. FastMap):

  pose sweep:   per-keyframe 6x6 Gauss-Newton with landmarks fixed —
                the edge list IS the kf_lm row structure, so this is one
                batched [K, M] residual evaluation + [K] solves, zero
                gather irregularity and embarrassingly parallel;
  point sweep:  per-landmark 3x3 Gauss-Newton with poses fixed —
                segment-sum scatter + batched 3x3 solves.

Each sweep is one jitted call; the distributed variant shards the KF axis
for pose sweeps (no communication) and psum-reduces landmark blocks
(parallel/sharded_ba.py pattern).  Convergence is linear rather than
quadratic, but each sweep costs O(edges) with perfect locality — the
right trade on this hardware; the windowed Schur solver remains available
for final polishing of bounded subsets.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aslam.config import BAConfig, CameraModel
from aslam.models.mapstate import MapState
from aslam.ops.ba import huber_weight, project_residual_jac
from aslam.ops.linalg import chol_inv, chol_solve
from aslam.utils.se3 import se3_exp


class GlobalBAStats(NamedTuple):
    chi2: jnp.ndarray
    n_edges: jnp.ndarray


def _edge_terms(m: MapState, cam: CameraModel, cfg: BAConfig, robust: bool):
    """Residual/Jacobian arrays over the [K, M] observation grid."""
    K, M = m.kf_lm.shape
    lm = jnp.maximum(m.kf_lm, 0)
    pts = m.lm_pos[lm]                                   # [K,M,3]

    def per_kf(T, p, uv, ur):
        return project_residual_jac(T, p, uv, ur, cam)

    r, Jc, Jp, depth_ok = jax.vmap(per_kf)(
        m.kf_T_cw, pts, m.kf_xy, m.kf_ur
    )                                                    # [K,M,...]
    is_stereo = m.kf_ur >= 0
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], -1
    )
    r = jnp.where(row_mask, r, 0.0)
    Jc = jnp.where(row_mask[..., None], Jc, 0.0)
    Jp = jnp.where(row_mask[..., None], Jp, 0.0)

    info = jnp.where(m.kf_z > 1e-3, 1.0 / jnp.maximum(m.kf_z, 1e-3) ** 2, 0.0)
    chi2 = jnp.sum(r * r, -1) * info
    chi2_th = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_huber = huber_weight(chi2, chi2_th) if robust else jnp.ones_like(chi2)
    active = (
        (m.kf_lm >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
        & m.lm_valid[lm] & depth_ok
    )
    w = info * w_huber * active
    return r, Jc, Jp, w, chi2, active, lm


@functools.partial(jax.jit, static_argnames=("cam", "cfg"))
def map_chi2(m: MapState, cam: CameraModel, cfg: BAConfig) -> jnp.ndarray:
    """Total active reprojection chi2 of the whole map (diagnostic)."""
    _, _, _, _, chi2, active, _ = _edge_terms(m, cam, cfg, robust=False)
    return jnp.sum(jnp.where(active, chi2, 0.0))


@functools.partial(jax.jit, static_argnames=("cam", "cfg", "robust"))
def ba_sweep(m: MapState, cam: CameraModel, cfg: BAConfig,
             robust: bool = True, lam: float = 1e-4):
    """One alternating sweep: pose update then point update."""
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]

    # ---- pose sweep (landmarks fixed) ----
    r, Jc, _, w, _, _, _ = _edge_terms(m, cam, cfg, robust)
    H = jnp.einsum("km,kmri,kmrj->kij", w, Jc, Jc)       # [K,6,6]
    b = jnp.einsum("km,kmri,kmr->ki", w, Jc, r)
    H = H + lam * jnp.eye(6) * jnp.maximum(
        jnp.trace(H, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
    ) + 1e-8 * jnp.eye(6)
    dx = -chol_solve(H, b)
    dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
    # gauge: hold the oldest valid KF fixed
    oldest = jnp.argmax(jnp.where(m.kf_valid, -m.kf_id, -(2**30)))
    freeze = (jnp.arange(K) == oldest) | ~m.kf_valid
    dx = jnp.where(freeze[:, None], 0.0, dx)
    new_T = jax.vmap(se3_exp)(dx) @ m.kf_T_cw
    m = m._replace(kf_T_cw=new_T)

    # ---- point sweep (poses fixed) ----
    r, _, Jp, w, chi2, active, lm = _edge_terms(m, cam, cfg, robust)
    wJp = w[..., None, None] * Jp                        # [K,M,3,3]
    Hll = jnp.zeros((L, 3, 3)).at[lm].add(
        jnp.einsum("kmri,kmrj->kmij", wJp, Jp)
    )
    bl = jnp.zeros((L, 3)).at[lm].add(
        jnp.einsum("kmri,kmr->kmi", wJp, r)
    )
    Hll = Hll + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hll, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    ) + 1e-8 * jnp.eye(3)
    dxl = -chol_solve(Hll, bl)
    dxl = jnp.where(m.lm_valid[:, None] & jnp.isfinite(dxl), dxl, 0.0)
    m = m._replace(lm_pos=m.lm_pos + dxl)

    stats = GlobalBAStats(
        chi2=jnp.sum(jnp.where(active, chi2, 0.0)),
        n_edges=jnp.sum(active.astype(jnp.int32)),
    )
    return m, stats


def global_ba(m: MapState, cam: CameraModel, cfg: BAConfig,
              iters: int = 20, robust_iters: int = 10,
              method: str = "sweep", kf_chunk: int | None = None,
              chain=None):
    """Full-map refinement.  `method`:
      "sweep"  — alternating resection/intersection (cheapest per iter)
      "gn_cg"  — joint Gauss-Newton with matrix-free PCG (fewer, better
                 iterations; measured 2x lower pose error on weak-gauge
                 corridors at equal iteration count)
    `chain` (ops/lba.ChainSpec, gn_cg only): odometry-chain regularizer
    anchoring consecutive-KF relative poses (see gn_cg_step).
    """
    if chain is not None and method != "gn_cg":
        raise ValueError("chain regularizer requires method='gn_cg'")
    stats = None
    K = m.kf_lm.shape[0]
    chunk = kf_chunk or min(256, K)
    for i in range(iters):
        robust = i < robust_iters
        if method == "gn_cg":
            m, stats = gn_cg_step(m, cam, cfg, robust=robust,
                                  kf_chunk=chunk, chain=chain)
        else:
            m, stats = ba_sweep(m, cam, cfg, robust=robust)
    return m, stats


# ---------------------------------------------------------------- joint GN-CG

@functools.partial(
    jax.jit, static_argnames=("cam", "cfg", "robust", "cg_iters", "kf_chunk")
)
def gn_cg_step(m: MapState, cam: CameraModel, cfg: BAConfig,
               robust: bool = True, cg_iters: int = 32, lam: float = 1e-3,
               kf_chunk: int = 256, chain=None):
    """One JOINT Gauss-Newton step over all poses and points, solved
    matrix-free with block-Jacobi-preconditioned CG.

    Unlike the alternating sweeps (linear convergence — each half-step
    ignores the camera-point coupling), this solves the coupled normal
    equations; unlike the windowed Schur solver it never materializes a
    dense system.  Each Hv product is one streamed pass over the [K, M]
    edge grid in chunks of `kf_chunk` rows (Jacobian blocks are
    recomputed per pass — ~100 flop/edge, far cheaper than storing them
    at 10k-KF scale).
    """
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]
    assert K % kf_chunk == 0
    n_chunks = K // kf_chunk
    oldest = jnp.argmax(jnp.where(m.kf_valid, -m.kf_id, -(2**30)))
    cam_free = m.kf_valid & (jnp.arange(K) != oldest)
    pt_free = m.lm_valid

    def chunk_view(c):
        s = c * kf_chunk
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s, kf_chunk)  # noqa: E731
        return m._replace(
            kf_T_cw=sl(m.kf_T_cw), kf_valid=sl(m.kf_valid),
            kf_id=sl(m.kf_id), kf_xy=sl(m.kf_xy), kf_ur=sl(m.kf_ur),
            kf_z=sl(m.kf_z), kf_desc=sl(m.kf_desc),
            kf_octave=sl(m.kf_octave), kf_kp_valid=sl(m.kf_kp_valid),
            kf_lm=sl(m.kf_lm),
        )

    # ---- gradient b and block-diagonal preconditioner (one pass) ----
    def grad_body(c, acc):
        bc, bl, Dc, Dl = acc
        mc = chunk_view(c)
        r, Jc, Jp, w, _, _, lm = _edge_terms(mc, cam, cfg, robust)
        wJc = w[..., None, None] * Jc
        wJp = w[..., None, None] * Jp
        bc = jax.lax.dynamic_update_slice_in_dim(
            bc, jnp.einsum("kmri,kmr->ki", wJc, r), c * kf_chunk, axis=0)
        bl = bl.at[lm].add(jnp.einsum("kmri,kmr->kmi", wJp, r))
        Dc = jax.lax.dynamic_update_slice_in_dim(
            Dc, jnp.einsum("kmri,kmrj->kij", wJc, Jc), c * kf_chunk, axis=0)
        Dl = Dl.at[lm].add(jnp.einsum("kmri,kmrj->kmij", wJp, Jp))
        return bc, bl, Dc, Dl

    bc, bl, Dc, Dl = jax.lax.fori_loop(
        0, n_chunks, grad_body,
        (jnp.zeros((K, 6)), jnp.zeros((L, 3)),
         jnp.zeros((K, 6, 6)), jnp.zeros((L, 3, 3))),
    )

    # odometry-chain regularizer (ops/lba.ChainSpec): relative-pose edges
    # between consecutive KFs anchored at the incoming (e.g. pose-graph-
    # corrected) chain — without it a whole-map reprojection-only re-solve
    # shears the chain to fit correlated landmark depth noise (the same
    # failure the windowed LBA chain fixes; measured 3.1 m session ATE
    # from repeated unregularized post-loop GBA, r3 scale rehearsal).
    if chain is not None:
        from aslam.ops.pose_graph import _edge_jacobians, edge_residual

        T_i = m.kf_T_cw[chain.c_i]
        T_j = m.kf_T_cw[chain.c_j]
        r_ch = jax.vmap(edge_residual)(T_i, T_j, chain.c_meas)   # [P,6]
        Ji, Jj = jax.vmap(_edge_jacobians)(T_i, T_j, chain.c_meas)
        wJi = chain.c_w[:, None, None] * Ji
        wJj = chain.c_w[:, None, None] * Jj
        bc = bc.at[chain.c_i].add(jnp.einsum("eri,er->ei", wJi, r_ch))
        bc = bc.at[chain.c_j].add(jnp.einsum("eri,er->ei", wJj, r_ch))
        Dc = Dc.at[chain.c_i].add(jnp.einsum("eri,erj->eij", wJi, Ji))
        Dc = Dc.at[chain.c_j].add(jnp.einsum("eri,erj->eij", wJj, Jj))

    bc = jnp.where(cam_free[:, None], bc, 0.0)
    bl = jnp.where(pt_free[:, None], bl, 0.0)
    # RELATIVE (trace-scaled) damping: normal-equation blocks reach ~1e11
    # when info = 1/z^2 meets near-camera depths (z ~ 1e-3), where an
    # absolute lam of 1e-3 is meaningless — the unpivoted f32 Cholesky
    # breaks down on the near-singular blocks and the preconditioned
    # residual explodes (measured |z0| ~ 1e27 on a real session map, dx
    # collapsing to 0 through the isfinite mask; r5).  The same lam_c /
    # lam_l enter the Hv product so CG solves exactly (H + diag(lam_*)) x = -b.
    lam_c = lam * jnp.maximum(
        jnp.trace(Dc, axis1=-2, axis2=-1) / 6.0, 1.0) + 1e-8   # [K]
    lam_l = lam * jnp.maximum(
        jnp.trace(Dl, axis1=-2, axis2=-1) / 3.0, 1.0) + 1e-8   # [L]
    Dc_inv = chol_inv(Dc + lam_c[:, None, None] * jnp.eye(6))
    Dl_inv = chol_inv(Dl + lam_l[:, None, None] * jnp.eye(3))

    def Hv(vc, vl):
        def body(c, acc):
            oc, ol = acc
            mc = chunk_view(c)
            _, Jc, Jp, w, _, _, lm = _edge_terms(mc, cam, cfg, robust)
            vc_c = jax.lax.dynamic_slice_in_dim(vc, c * kf_chunk, kf_chunk)
            q = (jnp.einsum("kmri,ki->kmr", Jc, vc_c)
                 + jnp.einsum("kmri,kmi->kmr", Jp, vl[lm]))
            wq = w[..., None] * q
            oc = jax.lax.dynamic_update_slice_in_dim(
                oc, jnp.einsum("kmri,kmr->ki", Jc, wq), c * kf_chunk, axis=0)
            ol = ol.at[lm].add(jnp.einsum("kmri,kmr->kmi", Jp, wq))
            return oc, ol

        oc, ol = jax.lax.fori_loop(
            0, n_chunks, body, (jnp.zeros((K, 6)), jnp.zeros((L, 3))))
        if chain is not None:
            q = (jnp.einsum("eij,ej->ei", Ji, vc[chain.c_i])
                 + jnp.einsum("eij,ej->ei", Jj, vc[chain.c_j]))
            oc = oc.at[chain.c_i].add(jnp.einsum("eri,er->ei", wJi, q))
            oc = oc.at[chain.c_j].add(jnp.einsum("eri,er->ei", wJj, q))
        oc = jnp.where(cam_free[:, None], oc + lam_c[:, None] * vc, 0.0)
        ol = jnp.where(pt_free[:, None], ol + lam_l[:, None] * vl, 0.0)
        return oc, ol

    def precond(vc, vl):
        pc = jnp.where(cam_free[:, None],
                       jnp.einsum("kij,kj->ki", Dc_inv, vc), 0.0)
        pl = jnp.where(pt_free[:, None],
                       jnp.einsum("kij,kj->ki", Dl_inv, vl), 0.0)
        return pc, pl

    def dot(a, b):
        return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

    # PCG for H x = -b
    x = (jnp.zeros((K, 6)), jnp.zeros((L, 3)))
    rres = (-bc, -bl)
    z = precond(*rres)
    p = z
    rz = dot(rres, z)

    def cg_body(_, carry):
        x, rres, p, rz = carry
        Hp = Hv(*p)
        denom = dot(p, Hp)
        alpha = jnp.where(jnp.abs(denom) > 1e-12, rz / denom, 0.0)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        rres = (rres[0] - alpha * Hp[0], rres[1] - alpha * Hp[1])
        z = precond(*rres)
        rz_new = dot(rres, z)
        beta = jnp.where(jnp.abs(rz) > 1e-12, rz_new / rz, 0.0)
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
        return x, rres, p, rz_new

    x, *_ = jax.lax.fori_loop(0, cg_iters, cg_body, (x, rres, p, rz))
    dxc = jnp.where(jnp.isfinite(x[0]) & cam_free[:, None], x[0], 0.0)
    dxl = jnp.where(jnp.isfinite(x[1]) & pt_free[:, None], x[1], 0.0)

    new_T = jax.vmap(se3_exp)(dxc) @ m.kf_T_cw
    m = m._replace(kf_T_cw=new_T, lm_pos=m.lm_pos + dxl)

    _, _, _, _, chi2, active, _ = _edge_terms(m, cam, cfg, robust=False)
    return m, GlobalBAStats(
        chi2=jnp.sum(jnp.where(active, chi2, 0.0)),
        n_edges=jnp.sum(active.astype(jnp.int32)),
    )


# ------------------------------------------------------------------ chunked

@functools.partial(
    jax.jit, static_argnames=("cam", "cfg", "robust", "kf_chunk")
)
def ba_sweep_chunked(m: MapState, cam: CameraModel, cfg: BAConfig,
                     robust: bool = True, lam: float = 1e-4,
                     kf_chunk: int = 256):
    """Memory-bounded sweep for 10k+-keyframe maps (BASELINE config 5).

    The dense sweep materializes [K, M, 3, 6] Jacobian blocks (~0.8 GB at
    10k x 1k); this variant streams KF rows in chunks of `kf_chunk`
    through a fori_loop, keeping peak extra memory at
    O(kf_chunk * M * 18) while accumulating the landmark normal equations
    across chunks.  Bitwise-equivalent math to ba_sweep.
    """
    K, M = m.kf_lm.shape
    L = m.lm_pos.shape[0]
    assert K % kf_chunk == 0, f"K={K} must divide by kf_chunk={kf_chunk}"
    n_chunks = K // kf_chunk
    oldest = jnp.argmax(jnp.where(m.kf_valid, -m.kf_id, -(2**30)))

    def chunk_view(c):
        s = c * kf_chunk
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s, kf_chunk)  # noqa: E731
        return m._replace(
            kf_T_cw=sl(m.kf_T_cw), kf_valid=sl(m.kf_valid),
            kf_id=sl(m.kf_id), kf_xy=sl(m.kf_xy), kf_ur=sl(m.kf_ur),
            kf_z=sl(m.kf_z), kf_desc=sl(m.kf_desc),
            kf_octave=sl(m.kf_octave), kf_kp_valid=sl(m.kf_kp_valid),
            kf_lm=sl(m.kf_lm),
        )

    # ---- pose sweep, chunked ----
    def pose_body(c, kf_T_new):
        mc = chunk_view(c)
        r, Jc, _, w, _, _, _ = _edge_terms(mc, cam, cfg, robust)
        H = jnp.einsum("km,kmri,kmrj->kij", w, Jc, Jc)
        b = jnp.einsum("km,kmri,kmr->ki", w, Jc, r)
        H = H + lam * jnp.eye(6) * jnp.maximum(
            jnp.trace(H, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
        ) + 1e-8 * jnp.eye(6)
        dx = -chol_solve(H, b)
        rows = c * kf_chunk + jnp.arange(kf_chunk)
        freeze = (rows == oldest) | ~mc.kf_valid
        dx = jnp.where(jnp.isfinite(dx) & ~freeze[:, None], dx, 0.0)
        upd = jax.vmap(se3_exp)(dx) @ mc.kf_T_cw
        return jax.lax.dynamic_update_slice_in_dim(
            kf_T_new, upd, c * kf_chunk, axis=0)

    kf_T = jax.lax.fori_loop(0, n_chunks, pose_body, m.kf_T_cw)
    m = m._replace(kf_T_cw=kf_T)

    # ---- point sweep, accumulated over chunks ----
    def point_body(c, acc):
        Hll, bl, chi2_sum, n_act = acc
        mc = chunk_view(c)
        r, _, Jp, w, chi2, active, lm = _edge_terms(mc, cam, cfg, robust)
        wJp = w[..., None, None] * Jp
        Hll = Hll.at[lm].add(jnp.einsum("kmri,kmrj->kmij", wJp, Jp))
        bl = bl.at[lm].add(jnp.einsum("kmri,kmr->kmi", wJp, r))
        chi2_sum = chi2_sum + jnp.sum(jnp.where(active, chi2, 0.0))
        n_act = n_act + jnp.sum(active.astype(jnp.int32))
        return Hll, bl, chi2_sum, n_act

    Hll, bl, chi2_sum, n_act = jax.lax.fori_loop(
        0, n_chunks, point_body,
        (jnp.zeros((L, 3, 3)), jnp.zeros((L, 3)), jnp.float32(0),
         jnp.int32(0)),
    )
    Hll = Hll + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hll, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    ) + 1e-8 * jnp.eye(3)
    dxl = -chol_solve(Hll, bl)
    dxl = jnp.where(m.lm_valid[:, None] & jnp.isfinite(dxl), dxl, 0.0)
    m = m._replace(lm_pos=m.lm_pos + dxl)
    return m, GlobalBAStats(chi2=chi2_sum, n_edges=n_act)
