"""Detector/descriptor evaluation: homography tools, match filtering,
recall-precision curves.

Replaces `Utils/utils.cpp:40-166` (FindHomography via cv::findHomography,
DistanceFiler reprojection gate, TestRecallPrecision 300-threshold sweep)
— the benchmarking machinery behind the reference's repeatability and
recall/precision test programs (Tests/repeatability_test.cpp,
Tests/Recall-Precision.cpp) and their Matlab plots.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aslam.ops import hamming


def homography_dlt(src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted DLT homography fit: src/dst [N,2], w [N] -> H [3,3]
    (batched over leading dims).  Normalized-coordinates DLT via SVD."""
    # Hartley normalization
    wsum = jnp.sum(w, -1, keepdims=True) + 1e-9
    mu_s = jnp.einsum("...n,...ni->...i", w / wsum, src)
    mu_d = jnp.einsum("...n,...ni->...i", w / wsum, dst)
    s_s = jnp.einsum("...n,...n->...", w / wsum,
                     jnp.linalg.norm(src - mu_s[..., None, :], axis=-1)) + 1e-9
    s_d = jnp.einsum("...n,...n->...", w / wsum,
                     jnp.linalg.norm(dst - mu_d[..., None, :], axis=-1)) + 1e-9
    sn = (src - mu_s[..., None, :]) / s_s[..., None, None]
    dn = (dst - mu_d[..., None, :]) / s_d[..., None, None]

    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = jnp.concatenate([r1 * jnp.sqrt(w)[..., None],
                         r2 * jnp.sqrt(w)[..., None]], -2)   # [...,2N,9]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    h = Vt[..., -1, :]
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # denormalize: H = T_d^-1 Hn T_s
    def trans(mu, s):
        T = jnp.zeros(mu.shape[:-1] + (3, 3))
        T = T.at[..., 0, 0].set(1.0 / s).at[..., 1, 1].set(1.0 / s)
        T = T.at[..., 0, 2].set(-mu[..., 0] / s).at[..., 1, 2].set(-mu[..., 1] / s)
        T = T.at[..., 2, 2].set(1.0)
        return T

    T_s = trans(mu_s, s_s)
    T_d_inv = jnp.linalg.inv(trans(mu_d, s_d))
    H = T_d_inv @ Hn @ T_s
    return H / (H[..., 2:3, 2:3] + 1e-12)


def apply_homography(H: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    ph = jnp.concatenate([pts, jnp.ones(pts.shape[:-1] + (1,))], -1)
    q = jnp.einsum("...ij,...nj->...ni", H, ph)
    return q[..., :2] / (q[..., 2:3] + 1e-12)


@functools.partial(jax.jit, static_argnames=("n_hyp", "refine"))
def find_homography_ransac(
    src: jnp.ndarray, dst: jnp.ndarray, valid: jnp.ndarray,
    key: jnp.ndarray, thresh_px: float = 3.0, n_hyp: int = 128,
    refine: int = 2,
):
    """RANSAC homography (cv::findHomography equivalent): parallel 4-point
    hypotheses -> DLT -> inlier count -> masked refit."""
    N = src.shape[0]
    n_good = jnp.sum(valid.astype(jnp.int32))
    csum = jnp.cumsum(valid.astype(jnp.int32))
    r = jax.random.randint(key, (n_hyp, 4), 0, jnp.maximum(n_good, 1))
    sample = jnp.clip(jnp.searchsorted(csum, r, side="right"), 0, N - 1)

    H0 = homography_dlt(src[sample], dst[sample], jnp.ones((n_hyp, 4)))

    def inliers_of(H):
        proj = apply_homography(H, jnp.broadcast_to(src, (n_hyp, N, 2)))
        err = jnp.linalg.norm(proj - dst[None], axis=-1)
        return valid[None, :] & (err < thresh_px)

    H = H0
    for _ in range(refine):
        inl = inliers_of(H)
        H = homography_dlt(
            jnp.broadcast_to(src, (n_hyp, N, 2)),
            jnp.broadcast_to(dst, (n_hyp, N, 2)),
            inl.astype(jnp.float32),
        )
    inl = inliers_of(H)
    n = jnp.sum(inl, axis=1)
    best = jnp.argmax(n)
    return H[best], inl[best], n[best]


def distance_filter(
    src_xy: np.ndarray, dst_xy: np.ndarray, H: np.ndarray,
    max_px: float = 3.0,
) -> np.ndarray:
    """Reprojection gate for putative matches under a known homography
    (utils.cpp:40-92 DistanceFiler)."""
    proj = np.asarray(apply_homography(jnp.asarray(H), jnp.asarray(src_xy)))
    return np.linalg.norm(proj - dst_xy, axis=-1) <= max_px


def recall_precision_curve(
    desc1: np.ndarray, desc2: np.ndarray,
    xy1: np.ndarray, xy2: np.ndarray,
    H_12: np.ndarray, eps_px: float = 3.0, n_thresholds: int = 300,
):
    """Recall/precision over descriptor-distance thresholds
    (utils.cpp:94-166): ground-truth correspondence = reprojection within
    eps under the known homography; a match at threshold t is any pair
    with descriptor distance <= t and mutual nearest."""
    d = np.asarray(hamming.distance_matrix(
        jnp.asarray(desc1), jnp.asarray(desc2)))
    nn2 = d.argmin(axis=1)
    nn_dist = d.min(axis=1)
    proj = np.asarray(apply_homography(jnp.asarray(H_12), jnp.asarray(xy1)))
    gt_ok = np.linalg.norm(proj - xy2[nn2], axis=-1) <= eps_px
    # total ground-truth correspondences: kp1 whose projection has any kp2
    # within eps
    dist_all = np.linalg.norm(proj[:, None, :] - xy2[None, :, :], axis=-1)
    has_gt = (dist_all <= eps_px).any(axis=1)
    n_gt = max(int(has_gt.sum()), 1)

    ts = np.linspace(0, 256, n_thresholds)
    recall, precision = [], []
    for t in ts:
        matched = nn_dist <= t
        tp = int((matched & gt_ok).sum())
        fp = int((matched & ~gt_ok).sum())
        recall.append(tp / n_gt)
        precision.append(tp / max(tp + fp, 1))
    return ts, np.asarray(recall), np.asarray(precision)
