"""SE(3) / SO(3) utilities as batched jnp ops.

Replaces the reference's Eigen/g2o small-matrix code (Utils/converter.cpp,
Odometry/kabsch.cpp) with vmappable, jit-friendly float32 routines.  Poses
are 4x4 homogeneous `T` matrices (world-to-camera `Tcw` by convention, as in
the reference Core/frame.cpp:58-98); twist vectors are `[rho(3), phi(3)]`
(translation first, rotation second) matching g2o's SE3Quat ordering.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: v (...,3) -> skew-symmetric (...,3,3)."""
    zeros = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: rotation vector (...,3) -> rotation matrix (...,3,3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    # Taylor-safe coefficients
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0
    )
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (...,3,3) -> rotation vector (...,3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)
    # theta/(2 sin theta), Taylor-safe near 0; near pi fall back to the
    # diagonal-based extraction.
    small = jnp.abs(sin_theta) < 1e-5
    scale = jnp.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_theta + _EPS))
    log_generic = scale[..., None] * w
    # Near theta = pi: |w| ~ 0, use axis from R diagonal.
    near_pi = cos_theta < -1.0 + 1e-4
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis_sq)
    # fix signs using off-diagonal sums
    sx = jnp.where(R[..., 2, 1] - R[..., 1, 2] < 0, -1.0, 1.0)
    sy = jnp.where(R[..., 0, 2] - R[..., 2, 0] < 0, -1.0, 1.0)
    sz = jnp.where(R[..., 1, 0] - R[..., 0, 1] < 0, -1.0, 1.0)
    # prefer consistency with largest axis via products R[i,j]+R[j,i]
    axis = axis * jnp.stack([sx, sy, sz], axis=-1)
    log_pi = theta[..., None] * axis / (
        jnp.linalg.norm(axis, axis=-1, keepdims=True) + _EPS
    )
    return jnp.where(near_pi[..., None], log_pi, log_generic)


def _so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    a = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0
    )
    b = jnp.where(
        theta2 > _EPS,
        (theta - jnp.sin(theta)) / (theta2 * theta + _EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) twist [rho, phi] (...,6) -> homogeneous transform (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = jnp.einsum("...ij,...j->...i", _so3_left_jacobian(phi), rho)
    return rt_to_T(R, t)


def _inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of batched 3x3 matrices — a pure
    fused VPU dag; `jnp.linalg.solve`'s batched LU is ~100x slower on
    small batched systems (r5 profile)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], -1),
        jnp.stack([c10, c11, c12], -1),
        jnp.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Homogeneous transform (...,4,4) -> twist [rho, phi] (...,6)."""
    R, t = T_to_rt(T)
    phi = so3_log(R)
    J = _so3_left_jacobian(phi)
    # J is the SO(3) left Jacobian — well-conditioned below the pi cutoff
    # so3_log already enforces; closed-form inverse beats batched LU
    rho = jnp.einsum("...ij,...j->...i", _inv3(J), t)
    return jnp.concatenate([rho, phi], axis=-1)


def rt_to_T(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(...,3,3) + (...,3) -> (...,4,4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def T_to_rt(T: jnp.ndarray):
    return T[..., :3, :3], T[..., :3, 3]


def T_inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a rigid transform."""
    R, t = T_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (...,4,4) to points (...,N,3)."""
    R, t = T_to_rt(T)
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rotation_angle(R: jnp.ndarray) -> jnp.ndarray:
    """Geodesic rotation angle in radians (used by the keyframe trigger,
    reference tracking.cpp:449-460 uses sum of |rvec|)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return jnp.arccos(jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0))


def R_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order
    (reference tracking.cpp:577-578 writes qx qy qz qw)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def branch_w():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, _EPS)) * 2.0
        return jnp.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, s / 4.0], -1)

    def branch_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2.0
        return jnp.stack([s / 4.0, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)

    def branch_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, _EPS)) * 2.0
        return jnp.stack([(m01 + m10) / s, s / 4.0, (m12 + m21) / s, (m02 - m20) / s], -1)

    def branch_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, _EPS)) * 2.0
        return jnp.stack([(m02 + m20) / s, (m12 + m21) / s, s / 4.0, (m10 - m01) / s], -1)

    qw, qx, qy, qz = branch_w(), branch_x(), branch_y(), branch_z()
    use_w = tr > 0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = jnp.where(
        use_w[..., None], qw,
        jnp.where(use_x[..., None], qx, jnp.where(use_y[..., None], qy, qz)),
    )
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)


def quat_to_R(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


def weighted_kabsch(
    src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray
) -> jnp.ndarray:
    """Weighted rigid alignment: find T (4x4) minimizing sum_i w_i |T src_i - dst_i|^2.

    This is the batched replacement for both
    `pcl::TransformationFromCorrespondences` (reference ransac.cpp:295-313,
    weighted by 1/(z1*z2)) and the standalone SVD Kabsch
    (reference kabsch.cpp:14-57).  Batched over leading dims; w may be zero
    for padded/invalid correspondences.

    src, dst: (..., N, 3); w: (..., N).  Returns (..., 4, 4).
    """
    w = jnp.maximum(w, 0.0)
    wsum = jnp.sum(w, axis=-1, keepdims=True) + _EPS
    wn = w / wsum
    mu_s = jnp.einsum("...n,...ni->...i", wn, src)
    mu_d = jnp.einsum("...n,...ni->...i", wn, dst)
    src_c = src - mu_s[..., None, :]
    dst_c = dst - mu_d[..., None, :]
    # cross-covariance H = sum w * src_c dst_c^T
    H = jnp.einsum("...n,...ni,...nj->...ij", wn, src_c, dst_c)
    # Horn's closed-form quaternion solution: the optimal rotation is the
    # largest eigenvector of the symmetric 4x4 N(H); solved by a shifted
    # power iteration (pure batched 4x4 matmuls) in place of an iterative
    # batched 3x3 jnp.linalg.svd; it is reflection-proof by construction
    # (a unit quaternion always encodes a proper rotation).
    hxx, hxy, hxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    hyx, hyy, hyz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    hzx, hzy, hzz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = jnp.stack([
        jnp.stack([hxx + hyy + hzz, hyz - hzy, hzx - hxz, hxy - hyx], -1),
        jnp.stack([hyz - hzy, hxx - hyy - hzz, hxy + hyx, hzx + hxz], -1),
        jnp.stack([hzx - hxz, hxy + hyx, hyy - hxx - hzz, hyz + hzy], -1),
        jnp.stack([hxy - hyx, hzx + hxz, hyz + hzy, hzz - hxx - hyy], -1),
    ], -2)                                               # [...,4,4]
    # shift so the max eigenvalue of N becomes the dominant one of N+sI
    s = jnp.sum(jnp.abs(N), axis=-1).max(axis=-1)        # Gershgorin bound
    Ns = N + (s + _EPS)[..., None, None] * jnp.eye(4, dtype=N.dtype)
    # repeated squaring: Ns^(2^12) concentrates the dominant eigenspace
    # even when the eigen gap is tiny (3-point minimal samples routinely
    # have |lambda2/lambda1| ~ 0.99, where plain power iteration stalls);
    # Frobenius renormalization keeps the squarings in f32 range
    for _ in range(12):
        Ns = jnp.einsum("...ij,...jk->...ik", Ns, Ns)
        Ns = Ns / (jnp.linalg.norm(Ns, axis=(-2, -1),
                                   keepdims=True) + _EPS)
    q = jnp.einsum("...ij,...j->...i", Ns, jnp.broadcast_to(
        jnp.asarray([1.0, 1e-3, 2e-3, 3e-3], N.dtype), N.shape[:-1]))
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    # polish: shifted matvecs against the ORIGINAL matrix guard (a) a probe
    # vector near-orthogonal to the dominant eigenvector and (b) squaring
    # chains that failed to isolate it on near-degenerate minimal samples
    # (advisor r4).  Three steps measurably reduce the failure count on a
    # noise-free near-collinear 3-point stress suite (556 -> 534 / 2000
    # trials with residual > 1e-3); the residual floor (~3e-3 at unit
    # scale) is an f32 limit — the eigen gap that encodes the in-plane
    # rotation on such samples sits at ~1e-6 relative magnitude inside N,
    # at f32 arithmetic noise.  (An inverse-iteration/Rayleigh polish was
    # tried and does NOT beat this: the quotient comparison needed to
    # accept its step is itself below f32 resolution.)  Exactly-solvable
    # samples are unaffected (residual < 1e-6); under RANSAC the scoring
    # and masked refit absorb the rare degenerate-sample miss.
    for _ in range(3):
        q = jnp.einsum("...ij,...j->...i", N, q) + (
            s + _EPS)[..., None] * q
        q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    # Horn's eigenvector is (w, x, y, z); quat_to_R takes (x, y, z, w)
    R = quat_to_R(q[..., jnp.array([1, 2, 3, 0])])
    t = mu_d - jnp.einsum("...ij,...j->...i", R, mu_s)
    return rt_to_T(R, t)


def pose_distance(T_a: jnp.ndarray, T_b: jnp.ndarray):
    """(translation distance, rotation angle) between two poses."""
    d = T_inv(T_a) @ T_b
    R, t = T_to_rt(d)
    return jnp.linalg.norm(t, axis=-1), rotation_angle(R)


# vmapped/jitted convenience wrappers
batched_se3_exp = jax.jit(se3_exp)
batched_se3_log = jax.jit(se3_log)
