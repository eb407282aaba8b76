"""Distributed bundle adjustment: Schur-complement reduction over a device
mesh via shard_map + XLA collectives.

This is the multi-chip scaling story the reference lacks entirely
(single process, three pthreads — SURVEY.md §2.3).  Decomposition:

  * Edges (residual blocks) are sharded across ALL devices
    (P(('dp','lm'))): each device assembles normal-equation contributions
    for its shard — the g2o edge loop (localbundleadjustment.cpp:82-206)
    becomes an embarrassingly parallel per-shard `assemble`.
  * Per-camera blocks (Hcc, bc) are small -> full `psum` to every device;
    the reduced camera system solve is replicated (C <= ~hundreds).
  * Per-landmark blocks (Hll, bl) and the camera-landmark coupling W are
    `psum`'d over 'dp' and `psum_scatter`'d over 'lm', so each lm-shard
    owns L/n_lm landmarks: it inverts its 3x3 blocks, computes its
    contribution to the Schur complement S (psum over 'lm'), and
    back-substitutes its landmark updates (all_gather to rebuild the
    replicated point array).

Collectives used: psum, psum_scatter, all_gather — the interconnect-
friendly pattern (contributions reduce along the mesh, no host round-trips).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from aslam.config import BAConfig, CameraModel
from aslam.ops.lba import BAProblem, assemble, edge_terms
from aslam.ops.linalg import chol_inv
from aslam.utils.se3 import se3_exp

EDGE_AXES = ("dp", "lm")


def pad_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """Pad edge count to a multiple of the device count and landmark count
    to a multiple of the 'lm' axis (shard_map needs even shards)."""
    n_dev = mesh.devices.size
    n_lm = mesh.shape["lm"]
    E = prob.e_cam.shape[0]
    L = prob.points.shape[0]
    pe = (-E) % n_dev
    pl = (-L) % n_lm
    if pe:
        prob = prob._replace(
            e_cam=jnp.pad(prob.e_cam, (0, pe)),
            e_lm=jnp.pad(prob.e_lm, (0, pe)),
            e_uv=jnp.pad(prob.e_uv, ((0, pe), (0, 0))),
            e_ur=jnp.pad(prob.e_ur, (0, pe), constant_values=-1.0),
            e_z=jnp.pad(prob.e_z, (0, pe)),
            e_valid=jnp.pad(prob.e_valid, (0, pe)),
        )
    if pl:
        prob = prob._replace(
            points=jnp.pad(prob.points, ((0, pl), (0, 0))),
            point_valid=jnp.pad(prob.point_valid, (0, pl)),
        )
    return prob


def _one_iteration(local_prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                   robust: bool, lam: float):
    """One distributed LM iteration; runs inside shard_map.

    local_prob holds the device's edge shard + replicated cams/points.
    Returns (dxc [C,6] replicated, dxl_full [L,3] replicated, chi2).
    """
    C = local_prob.cam_T.shape[0]
    Hcc, bc, Hll, bl, W, chi2 = assemble(local_prob, cam, cfg, robust)

    # camera blocks: full reduction (small)
    Hcc = lax.psum(Hcc, EDGE_AXES)
    bc = lax.psum(bc, EDGE_AXES)
    chi2 = lax.psum(chi2, EDGE_AXES)

    # landmark blocks: reduce over 'dp', scatter blocks over 'lm'
    Hll_s = lax.psum_scatter(lax.psum(Hll, "dp"), "lm",
                             scatter_dimension=0, tiled=True)   # [L/nl,3,3]
    bl_s = lax.psum_scatter(lax.psum(bl, "dp"), "lm",
                            scatter_dimension=0, tiled=True)    # [L/nl,3]
    W_s = lax.psum_scatter(lax.psum(W, "dp"), "lm",
                           scatter_dimension=1, tiled=True)     # [C,L/nl,6,3]

    # landmark validity for this shard
    Ls = bl_s.shape[0]
    lm_idx0 = lax.axis_index("lm") * Ls
    pv_s = lax.dynamic_slice_in_dim(local_prob.point_valid, lm_idx0, Ls)

    eyes3 = jnp.broadcast_to(jnp.eye(3), Hll_s.shape)
    Hll_d = Hll_s + lam * eyes3 * jnp.maximum(
        jnp.trace(Hll_s, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    ) + 1e-8 * eyes3
    Hll_inv_s = chol_inv(Hll_d)

    # Schur contribution of this landmark shard
    Y_s = jnp.einsum("clij,ljk->clik", W_s, Hll_inv_s)
    S_contrib = jnp.einsum("clik,dljk->cidj", Y_s, W_s)
    S_contrib = lax.psum(S_contrib, "lm")                       # [C,6,C,6]
    rhs_contrib = lax.psum(jnp.einsum("clik,lk->ci", Y_s, bl_s), "lm")

    S = (-S_contrib).at[jnp.arange(C), :, jnp.arange(C), :].add(Hcc)
    S = S.reshape(C * 6, C * 6)
    rhs = (bc - rhs_contrib).reshape(C * 6)

    diag_scale = jnp.maximum(jnp.abs(jnp.diagonal(S)), 1e-6)
    S = S + jnp.diag(lam * diag_scale)
    fixed6 = jnp.repeat(local_prob.cam_fixed, 6)
    S = jnp.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + jnp.diag(jnp.where(fixed6, 1.0, 0.0))
    rhs = jnp.where(fixed6, 0.0, rhs)

    dxc = -jnp.linalg.solve(S, rhs).reshape(C, 6)               # replicated
    dxc = jnp.where(jnp.isfinite(dxc), dxc, 0.0)

    # landmark back-substitution on this shard, then regather
    Wt_dxc = jnp.einsum("clij,ci->lj", W_s, dxc)
    dxl_s = -jnp.einsum("lij,lj->li", Hll_inv_s, bl_s + Wt_dxc)
    dxl_s = jnp.where(pv_s[:, None] & jnp.isfinite(dxl_s), dxl_s, 0.0)
    dxl = lax.all_gather(dxl_s, "lm", axis=0, tiled=True)       # [L,3]
    return dxc, dxl, chi2


def _sharded_schedule(cam: CameraModel, cfg: BAConfig):
    """Body run by shard_map: full local-BA schedule with collectives."""

    def body(cam_T, cam_fixed, cam_valid, points, point_valid,
             e_cam, e_lm, e_uv, e_ur, e_z, e_valid):
        def mk(points, cam_T, e_valid):
            return BAProblem(cam_T, cam_fixed, cam_valid, points, point_valid,
                             e_cam, e_lm, e_uv, e_ur, e_z, e_valid)

        def iterate(n_iters, robust, carry):
            def it(_, c):
                cam_T, points, e_valid = c
                dxc, dxl, _ = _one_iteration(
                    mk(points, cam_T, e_valid), cam, cfg, robust, 1e-4
                )
                new_T = jax.vmap(se3_exp)(dxc) @ cam_T
                new_T = jnp.where(cam_fixed[:, None, None], cam_T, new_T)
                return (new_T, points + dxl, e_valid)

            return lax.fori_loop(0, n_iters, it, carry)

        carry = (cam_T, points, e_valid)
        carry = iterate(cfg.local_iters_1, True, carry)
        # prune outlier edges (local, elementwise on the shard)
        cam_T1, points1, e_valid1 = carry
        _, _, _, _, chi2_e, active = edge_terms(
            mk(points1, cam_T1, e_valid1), cam, cfg, robust=False
        )
        chi2_th = jnp.where(e_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
        carry = (cam_T1, points1, active & (chi2_e <= chi2_th))
        carry = iterate(cfg.local_iters_2, False, carry)

        cam_T2, points2, e_valid2 = carry
        # final chi2 via edge terms + psum
        _, _, _, _, chi2_e, active = edge_terms(
            mk(points2, cam_T2, e_valid2), cam, cfg, robust=False
        )
        chi2_total = lax.psum(jnp.sum(jnp.where(active, chi2_e, 0.0)), EDGE_AXES)
        n_edges = lax.psum(jnp.sum(active.astype(jnp.int32)), EDGE_AXES)
        return cam_T2, points2, e_valid2, chi2_total, n_edges

    return body


@functools.partial(jax.jit, static_argnames=("cam", "cfg", "mesh"))
def sharded_local_ba(prob: BAProblem, cam: CameraModel, cfg: BAConfig,
                     mesh: Mesh):
    """Distributed local-BA schedule.  Edge/landmark counts must already be
    padded to the mesh (see pad_problem).  Returns (problem, chi2, n_edges)."""
    body = _sharded_schedule(cam, cfg)
    rep = P()
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep,
                  P(EDGE_AXES), P(EDGE_AXES), P(EDGE_AXES), P(EDGE_AXES),
                  P(EDGE_AXES), P(EDGE_AXES)),
        out_specs=(rep, rep, P(EDGE_AXES), rep, rep),
        check_vma=False,
    )
    cam_T, points, e_valid, chi2, n_edges = sharded(
        prob.cam_T, prob.cam_fixed, prob.cam_valid, prob.points,
        prob.point_valid, prob.e_cam, prob.e_lm, prob.e_uv, prob.e_ur,
        prob.e_z, prob.e_valid,
    )
    return prob._replace(cam_T=cam_T, points=points, e_valid=e_valid), chi2, n_edges
