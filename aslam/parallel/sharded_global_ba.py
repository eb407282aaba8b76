"""Distributed global BA: alternating sweeps sharded over the device mesh.

Complements parallel/sharded_ba.py (windowed Schur) with the map-scale
path (BASELINE configs 4-5).  Decomposition per sweep:

  pose sweep:   keyframe rows shard over the whole mesh — each device
                solves the 6x6 systems of its KF shard with **zero
                communication** (landmarks replicated read-only), then
                poses all_gather.
  point sweep:  every device computes landmark normal-equation
                contributions from its KF shard; blocks reduce over the
                mesh with psum (+ psum_scatter over 'lm' so each lm-shard
                solves its own 3x3 systems), updates regather.

Covisibility-aware placement note (SURVEY.md §7.3 item 8): keyframes are
sharded by contiguous insertion ranges, which for SLAM trajectories means
temporally-adjacent (hence covisibility-connected) KFs land on the same
device, keeping the psum payload the only cross-device traffic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from aslam.config import BAConfig, CameraModel
from aslam.models.mapstate import MapState
from aslam.ops.ba import huber_weight, project_residual_jac
from aslam.ops.linalg import chol_solve
from aslam.utils.se3 import se3_exp

KF_AXES = ("dp", "lm")


def _shard_edge_terms(kf_T, kf_xy, kf_ur, kf_z, kf_lm, kf_kp_valid, kf_valid,
                      lm_pos, lm_valid, cam, cfg, robust):
    """Edge terms for a KF shard ([Ks, M] rows) against replicated
    landmarks."""
    lm = jnp.maximum(kf_lm, 0)
    pts = lm_pos[lm]

    r, Jc, Jp, depth_ok = jax.vmap(
        lambda T, p, uv, ur: project_residual_jac(T, p, uv, ur, cam)
    )(kf_T, pts, kf_xy, kf_ur)
    is_stereo = kf_ur >= 0
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], -1
    )
    r = jnp.where(row_mask, r, 0.0)
    Jc = jnp.where(row_mask[..., None], Jc, 0.0)
    Jp = jnp.where(row_mask[..., None], Jp, 0.0)
    info = jnp.where(kf_z > 1e-3, 1.0 / jnp.maximum(kf_z, 1e-3) ** 2, 0.0)
    chi2 = jnp.sum(r * r, -1) * info
    chi2_th = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_huber = huber_weight(chi2, chi2_th) if robust else jnp.ones_like(chi2)
    active = (
        (kf_lm >= 0) & kf_kp_valid & kf_valid[:, None] & lm_valid[lm] & depth_ok
    )
    w = info * w_huber * active
    return r, Jc, Jp, w, chi2, active, lm


@functools.partial(
    jax.jit, static_argnames=("cam", "cfg", "mesh", "iters", "robust_iters")
)
def sharded_global_ba(
    m: MapState, cam: CameraModel, cfg: BAConfig, mesh: Mesh,
    iters: int = 10, robust_iters: int = 5, lam: float = 1e-4,
):
    """Distributed alternating-sweep global BA.  K must divide by the
    device count and L by the 'lm' axis (pad_map below).  Returns
    (MapState with refined poses/points, final chi2)."""
    K = m.kf_T_cw.shape[0]
    L = m.lm_pos.shape[0]
    n_dev = mesh.devices.size

    oldest = jnp.argmax(jnp.where(m.kf_valid, -m.kf_id, -(2**30)))

    def body(kf_T, kf_xy, kf_ur, kf_z, kf_lm, kf_kp_valid, kf_valid,
             lm_pos, lm_valid, oldest_arr):
        Ks = kf_T.shape[0]
        # global row index of this shard's rows
        dev_linear = lax.axis_index("dp") * mesh.shape["lm"] + lax.axis_index("lm")
        row0 = dev_linear * Ks
        my_rows = row0 + jnp.arange(Ks)
        freeze = (my_rows == oldest_arr[0]) | ~kf_valid

        def sweep(carry, robust):
            kf_T, lm_pos = carry
            # ---- pose sweep: local to the shard ----
            r, Jc, _, w, _, _, _ = _shard_edge_terms(
                kf_T, kf_xy, kf_ur, kf_z, kf_lm, kf_kp_valid, kf_valid,
                lm_pos, lm_valid, cam, cfg, robust)
            H = jnp.einsum("km,kmri,kmrj->kij", w, Jc, Jc)
            b = jnp.einsum("km,kmri,kmr->ki", w, Jc, r)
            H = H + lam * jnp.eye(6) * jnp.maximum(
                jnp.trace(H, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
            ) + 1e-8 * jnp.eye(6)
            dx = -chol_solve(H, b)
            dx = jnp.where(jnp.isfinite(dx) & ~freeze[:, None], dx, 0.0)
            kf_T = jax.vmap(se3_exp)(dx) @ kf_T

            # ---- point sweep: psum over the mesh, solve lm shard ----
            r, _, Jp, w, chi2, active, lm = _shard_edge_terms(
                kf_T, kf_xy, kf_ur, kf_z, kf_lm, kf_kp_valid, kf_valid,
                lm_pos, lm_valid, cam, cfg, robust)
            wJp = w[..., None, None] * Jp
            Hll = jnp.zeros((L, 3, 3)).at[lm].add(
                jnp.einsum("kmri,kmrj->kmij", wJp, Jp))
            bl = jnp.zeros((L, 3)).at[lm].add(
                jnp.einsum("kmri,kmr->kmi", wJp, r))
            Hll_s = lax.psum_scatter(lax.psum(Hll, "dp"), "lm",
                                     scatter_dimension=0, tiled=True)
            bl_s = lax.psum_scatter(lax.psum(bl, "dp"), "lm",
                                    scatter_dimension=0, tiled=True)
            Ls = bl_s.shape[0]
            lm0 = lax.axis_index("lm") * Ls
            lv_s = lax.dynamic_slice_in_dim(lm_valid, lm0, Ls)
            Hll_s = Hll_s + lam * jnp.eye(3) * jnp.maximum(
                jnp.trace(Hll_s, axis1=-2, axis2=-1)[:, None, None] / 3.0,
                1e-6) + 1e-8 * jnp.eye(3)
            dxl_s = -chol_solve(Hll_s, bl_s)
            dxl_s = jnp.where(lv_s[:, None] & jnp.isfinite(dxl_s), dxl_s, 0.0)
            dxl = lax.all_gather(dxl_s, "lm", axis=0, tiled=True)
            lm_pos = lm_pos + dxl
            chi2_total = lax.psum(jnp.sum(jnp.where(active, chi2, 0.0)),
                                  KF_AXES)
            return (kf_T, lm_pos), chi2_total

        carry = (kf_T, lm_pos)
        chi2 = jnp.float32(0)
        for i in range(iters):
            carry, chi2 = sweep(carry, i < robust_iters)
        kf_T, lm_pos = carry
        return kf_T, lm_pos, chi2

    rep = P()
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(KF_AXES), P(KF_AXES), P(KF_AXES), P(KF_AXES),
                  P(KF_AXES), P(KF_AXES), P(KF_AXES), rep, rep, rep),
        out_specs=(P(KF_AXES), rep, rep),
        check_vma=False,
    )
    kf_T, lm_pos, chi2 = sharded(
        m.kf_T_cw, m.kf_xy, m.kf_ur, m.kf_z, m.kf_lm, m.kf_kp_valid,
        m.kf_valid, m.lm_pos, m.lm_valid, oldest[None],
    )
    return m._replace(kf_T_cw=kf_T, lm_pos=lm_pos), chi2


def pad_map_for_mesh(m: MapState, mesh: Mesh) -> MapState:
    """Pad K to a multiple of the device count and L to the 'lm' axis."""
    n_dev = mesh.devices.size
    n_lm = mesh.shape["lm"]
    K = m.kf_T_cw.shape[0]
    L = m.lm_pos.shape[0]
    pk = (-K) % n_dev
    pl = (-L) % n_lm
    if pk:
        import jax.numpy as jnp

        m = m._replace(
            kf_T_cw=jnp.concatenate(
                [m.kf_T_cw, jnp.tile(jnp.eye(4), (pk, 1, 1))]),
            kf_valid=jnp.pad(m.kf_valid, (0, pk)),
            kf_id=jnp.pad(m.kf_id, (0, pk), constant_values=-1),
            kf_xy=jnp.pad(m.kf_xy, ((0, pk), (0, 0), (0, 0))),
            kf_ur=jnp.pad(m.kf_ur, ((0, pk), (0, 0)), constant_values=-1.0),
            kf_z=jnp.pad(m.kf_z, ((0, pk), (0, 0))),
            kf_desc=jnp.pad(m.kf_desc, ((0, pk), (0, 0), (0, 0))),
            kf_octave=jnp.pad(m.kf_octave, ((0, pk), (0, 0))),
            kf_kp_valid=jnp.pad(m.kf_kp_valid, ((0, pk), (0, 0))),
            kf_lm=jnp.pad(m.kf_lm, ((0, pk), (0, 0)), constant_values=-1),
        )
    if pl:
        import jax.numpy as jnp

        m = m._replace(
            lm_pos=jnp.pad(m.lm_pos, ((0, pl), (0, 0))),
            lm_desc=jnp.pad(m.lm_desc, ((0, pl), (0, 0))),
            lm_valid=jnp.pad(m.lm_valid, (0, pl)),
            lm_first_kf=jnp.pad(m.lm_first_kf, (0, pl), constant_values=-1),
            lm_visible=jnp.pad(m.lm_visible, (0, pl)),
            lm_found=jnp.pad(m.lm_found, (0, pl)),
        )
    return m
