"""Spatially-uniform keypoint selection: grid-bucketed top-k.

Replaces `ORBextractor::DistributeOctTree` (reference
orbextractor.cpp:466-663), which recursively splits the image into quad-tree
nodes until there are >= nFeatures nodes and keeps the best-response keypoint
per node.  That algorithm is inherently sequential; the batched
equivalent ranks candidates by (rank-within-cell, response): every cell's
best corner is preferred over any cell's second corner, which yields the
same spatial-uniformity property (validated by tests on spatial dispersion,
not bit-identity — SURVEY.md §7.3 item 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_NEG = -1e9


def grid_topk(
    score: jnp.ndarray,
    cell: int,
    k_cell: int,
    n_out: int,
):
    """Select up to n_out keypoints from a response map, spatially uniform.

    score: [H,W] float32 NMS'd response (0 = no corner).  H, W need not be
    multiples of `cell` (remainder pixels fold into the last cells via
    padding).  Returns (xy [n_out,2] float32 (x, y), resp [n_out], valid
    [n_out] bool).
    """
    H, W = score.shape
    ph = (-H) % cell
    pw = (-W) % cell
    s = jnp.pad(score, ((0, ph), (0, pw)), constant_values=0.0)
    Hp, Wp = H + ph, W + pw
    gy, gx = Hp // cell, Wp // cell

    # [gy,gx,cell,cell] -> [ncells, cell*cell]
    cells = s.reshape(gy, cell, gx, cell).transpose(0, 2, 1, 3).reshape(
        gy * gx, cell * cell
    )
    k_cell = min(k_cell, cell * cell)
    top_vals, top_idx = jax.lax.top_k(cells, k_cell)      # [nc, k]

    # recover absolute pixel coordinates
    cy = (jnp.arange(gy * gx) // gx) * cell
    cx = (jnp.arange(gy * gx) % gx) * cell
    py = top_idx // cell + cy[:, None]
    px = top_idx % cell + cx[:, None]

    vals = top_vals.reshape(-1)
    ys = py.reshape(-1).astype(jnp.float32)
    xs = px.reshape(-1).astype(jnp.float32)
    ranks = jnp.broadcast_to(jnp.arange(k_cell)[None, :], top_idx.shape).reshape(-1)

    valid = vals > 0.0
    # primary: low rank (spatial spread), secondary: high response
    max_resp = 1e6
    key = jnp.where(valid, -ranks.astype(jnp.float32) * max_resp + jnp.minimum(vals, max_resp - 1), _NEG)
    n_out = min(n_out, key.shape[0])
    _, sel = jax.lax.top_k(key, n_out)

    out_xy = jnp.stack([xs[sel], ys[sel]], axis=-1)
    out_resp = vals[sel]
    out_valid = valid[sel]
    # guard padded-region picks (score 0 -> invalid anyway)
    out_valid = out_valid & (out_xy[:, 0] < W) & (out_xy[:, 1] < H)
    return out_xy, out_resp, out_valid


def subpixel_refine(score: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Quadratic sub-pixel refinement of keypoint locations on the raw
    (pre-NMS) response map: fit a 1-D parabola through the three samples
    along each axis and shift by its vertex, clamped to ±0.5 px.

    The reference keeps integer FAST corners (orbextractor has no subpixel
    stage); this is a strictly-better-accuracy addition that costs two
    gathers per keypoint.
    """
    H, W = score.shape
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 1, W - 2)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 1, H - 2)
    c = score[yi, xi]
    dx = score[yi, xi + 1] - score[yi, xi - 1]
    dxx = score[yi, xi + 1] - 2 * c + score[yi, xi - 1]
    dy = score[yi + 1, xi] - score[yi - 1, xi]
    dyy = score[yi + 1, xi] - 2 * c + score[yi - 1, xi]
    off_x = jnp.where(jnp.abs(dxx) > 1e-6, -0.5 * dx / dxx, 0.0)
    off_y = jnp.where(jnp.abs(dyy) > 1e-6, -0.5 * dy / dyy, 0.0)
    off = jnp.stack([jnp.clip(off_x, -0.5, 0.5),
                     jnp.clip(off_y, -0.5, 0.5)], axis=-1)
    return xy + off
