"""Distributed joint GN-CG bundle adjustment.

Shards the matrix-free PCG of ops/global_ba.gn_cg_step over the device
mesh: keyframe rows (and their edge grids) are sharded across ALL devices;
landmark-side quantities reduce with psum.  Per CG iteration the only
collectives are one psum of a [L,3] partial (the landmark half of Hv) and
two scalar psums (dot products) — camera-side state never leaves its
shard.  This is the config-5 decomposition: the 2.6M-edge Hv product
splits into embarrassingly parallel per-shard passes with one
all-reduce.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from aslam.config import BAConfig, CameraModel
from aslam.models.mapstate import MapState
from aslam.ops.global_ba import GlobalBAStats, _edge_terms
from aslam.ops.linalg import chol_inv
from aslam.utils.se3 import se3_exp

AXES = ("dp", "lm")


@functools.partial(
    jax.jit, static_argnames=("cam", "cfg", "mesh", "robust", "cg_iters")
)
def sharded_gn_cg_step(
    m: MapState, cam: CameraModel, cfg: BAConfig, mesh: Mesh,
    robust: bool = True, cg_iters: int = 32, lam: float = 1e-3,
):
    """One distributed joint GN step.  K must divide by the device count
    (parallel/sharded_global_ba.pad_map_for_mesh).  Returns (MapState,
    stats)."""
    K = m.kf_T_cw.shape[0]
    L = m.lm_pos.shape[0]
    oldest = jnp.argmax(jnp.where(m.kf_valid, -m.kf_id, -(2**30)))

    def body(kf_T, kf_xy, kf_ur, kf_z, kf_lm, kf_kp_valid, kf_valid,
             lm_pos, lm_valid, oldest_arr):
        Ks = kf_T.shape[0]
        dev = lax.axis_index("dp") * mesh.shape["lm"] + lax.axis_index("lm")
        my_rows = dev * Ks + jnp.arange(Ks)
        cam_free = kf_valid & (my_rows != oldest_arr[0])
        pt_free = lm_valid

        M_feat = kf_xy.shape[1]

        def local_view(T_local, pts):
            # fresh MapState from shard-local arrays (closing over the
            # outer traced MapState would replicate its big buffers)
            return MapState(
                kf_T_cw=T_local, kf_valid=kf_valid,
                kf_id=jnp.zeros(Ks, jnp.int32),
                kf_xy=kf_xy, kf_ur=kf_ur, kf_z=kf_z,
                kf_desc=jnp.zeros((Ks, M_feat, 8), jnp.uint32),
                kf_octave=jnp.zeros((Ks, M_feat), jnp.int32),
                kf_kp_valid=kf_kp_valid, kf_lm=kf_lm,
                lm_pos=pts, lm_desc=jnp.zeros((L, 8), jnp.uint32),
                lm_valid=lm_valid,
                lm_first_kf=jnp.zeros(L, jnp.int32),
                lm_visible=jnp.zeros(L, jnp.int32),
                lm_found=jnp.zeros(L, jnp.int32),
            )

        mc = local_view(kf_T, lm_pos)
        r, Jc, Jp, w, _, _, lm = _edge_terms(mc, cam, cfg, robust)
        wJc = w[..., None, None] * Jc
        wJp = w[..., None, None] * Jp

        bc = jnp.einsum("kmri,kmr->ki", wJc, r)                  # [Ks,6] local
        bc = jnp.where(cam_free[:, None], bc, 0.0)
        bl = lax.psum(
            jnp.zeros((L, 3)).at[lm].add(
                jnp.einsum("kmri,kmr->kmi", wJp, r)),
            AXES,
        )
        bl = jnp.where(pt_free[:, None], bl, 0.0)

        Dc = jnp.einsum("kmri,kmrj->kij", wJc, Jc)
        Dl = lax.psum(
            jnp.zeros((L, 3, 3)).at[lm].add(
                jnp.einsum("kmri,kmrj->kmij", wJp, Jp)),
            AXES,
        )
        # RELATIVE (trace-scaled) damping, same as ops/global_ba.gn_cg_step
        # (r5): absolute lam is meaningless against 1/z^2-scaled blocks —
        # the unpivoted f32 Cholesky breaks down and CG collapses
        lam_c = lam * jnp.maximum(
            jnp.trace(Dc, axis1=-2, axis2=-1) / 6.0, 1.0) + 1e-8
        lam_l = lam * jnp.maximum(
            jnp.trace(Dl, axis1=-2, axis2=-1) / 3.0, 1.0) + 1e-8
        Dc_inv = chol_inv(Dc + lam_c[:, None, None] * jnp.eye(6))
        Dl_inv = chol_inv(Dl + lam_l[:, None, None] * jnp.eye(3))

        def Hv(vc, vl):
            # vc: [Ks,6] local shard; vl: [L,3] replicated
            q = (jnp.einsum("kmri,ki->kmr", Jc, vc)
                 + jnp.einsum("kmri,kmi->kmr", Jp, vl[lm]))
            wq = w[..., None] * q
            oc = jnp.einsum("kmri,kmr->ki", Jc, wq) + lam_c[:, None] * vc
            oc = jnp.where(cam_free[:, None], oc, 0.0)
            ol = lax.psum(
                jnp.zeros((L, 3)).at[lm].add(
                    jnp.einsum("kmri,kmr->kmi", Jp, wq)),
                AXES,
            ) + lam_l[:, None] * vl
            ol = jnp.where(pt_free[:, None], ol, 0.0)
            return oc, ol

        def precond(vc, vl):
            pc = jnp.where(cam_free[:, None],
                           jnp.einsum("kij,kj->ki", Dc_inv, vc), 0.0)
            pl = jnp.where(pt_free[:, None],
                           jnp.einsum("kij,kj->ki", Dl_inv, vl), 0.0)
            return pc, pl

        def dot(a, b):
            # camera halves are disjoint shards -> psum; landmark halves
            # replicated -> count once
            return lax.psum(jnp.sum(a[0] * b[0]), AXES) + jnp.sum(a[1] * b[1])

        x = (jnp.zeros((Ks, 6)), jnp.zeros((L, 3)))
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

        x, *_ = lax.fori_loop(0, cg_iters, cg_body, (x, rres, p, rz))
        dxc = jnp.where(jnp.isfinite(x[0]) & cam_free[:, None], x[0], 0.0)
        dxl = jnp.where(jnp.isfinite(x[1]) & pt_free[:, None], x[1], 0.0)

        new_T = jax.vmap(se3_exp)(dxc) @ kf_T
        new_pts = lm_pos + dxl

        # stats on the updated state
        mc2 = local_view(new_T, new_pts)
        _, _, _, _, chi2, active, _ = _edge_terms(mc2, cam, cfg, robust=False)
        chi2_total = lax.psum(jnp.sum(jnp.where(active, chi2, 0.0)), AXES)
        n_edges = lax.psum(jnp.sum(active.astype(jnp.int32)), AXES)
        return new_T, new_pts, chi2_total, n_edges

    rep = P()
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXES), P(AXES), P(AXES), P(AXES), P(AXES), P(AXES),
                  P(AXES), rep, rep, rep),
        out_specs=(P(AXES), rep, rep, rep),
        check_vma=False,
    )
    kf_T, lm_pos, chi2, n_edges = sharded(
        m.kf_T_cw, m.kf_xy, m.kf_ur, m.kf_z, m.kf_lm, m.kf_kp_valid,
        m.kf_valid, m.lm_pos, m.lm_valid, oldest[None],
    )
    return m._replace(kf_T_cw=kf_T, lm_pos=lm_pos), GlobalBAStats(
        chi2=chi2, n_edges=n_edges)
