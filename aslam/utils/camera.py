"""Camera model ops: project / unproject / distort / undistort.

Replaces the reference's per-keypoint OpenCV calls:
  - backprojection `mvKeys3Dc` + pseudo-stereo `mvuRight` (frame.cpp:148-164)
  - `cv::undistortPoints` (frame.cpp:286-313) -> iterative Newton inversion
  - frustum check `Frame::isInFrustum` (frame.cpp:100-133)

All ops are batched over an (..., N) keypoint axis and jit-friendly.
"""

from __future__ import annotations

import jax.numpy as jnp

from aslam.config import CameraModel


def khoshelham_gate(z: jnp.ndarray, c: float = 0.01,
                    floor: float = 0.03) -> jnp.ndarray:
    """3-sigma depth-agreement gate from the Khoshelham noise model
    sigma_z = c * z^2 (the reference's own error model, ransac.cpp:423-431)
    plus a near-range floor.  Shared by the frame-level depth-patch gate
    and the landmark position-refresh trim so the two '3-sigma' gates stay
    in sync (ADVICE r2)."""
    return 3.0 * c * z * z + floor


def project(cam: CameraModel, pts_c: jnp.ndarray):
    """Camera-frame points (...,N,3) -> pixel coords (...,N,2) and depth (...,N).

    Pinhole only — by pipeline convention keypoints are undistorted once at
    extraction (as the reference does), so projection during matching/BA is
    distortion-free.
    """
    z = pts_c[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    u = cam.fx * pts_c[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_c[..., 1] * inv_z + cam.cy
    return jnp.stack([u, v], axis=-1), z


def unproject(cam: CameraModel, uv: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Pixels (...,N,2) + depth (...,N) -> camera-frame points (...,N,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return jnp.stack([x, y, z], axis=-1)


def u_right(cam: CameraModel, u: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Pseudo-stereo right-image coordinate u - bf/z (frame.cpp:162);
    -1 where depth invalid."""
    valid = z > 0
    return jnp.where(valid, u - cam.bf / jnp.where(valid, z, 1.0), -1.0)


def distort_normalized(cam: CameraModel, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xt = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yt = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return jnp.stack([x * radial + xt, y * radial + yt], axis=-1)


def undistort_points(cam: CameraModel, uv: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Invert the distortion model by fixed-point iteration (the same scheme
    cv::undistortPoints uses).  uv: distorted pixel coords (...,2) ->
    undistorted pixel coords (...,2)."""
    if not cam.has_distortion:
        return uv
    xd = jnp.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], axis=-1
    )
    x = xd
    for _ in range(iters):
        xy = x
        xx, yy = xy[..., 0], xy[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = (xd - jnp.stack([dx, dy], axis=-1)) / radial[..., None]
    return jnp.stack(
        [x[..., 0] * cam.fx + cam.cx, x[..., 1] * cam.fy + cam.cy], axis=-1
    )


def in_frustum(
    cam: CameraModel,
    T_cw: jnp.ndarray,
    pts_w: jnp.ndarray,
    margin: float = 0.0,
):
    """Frustum visibility test (frame.cpp:100-133): project world points with
    pose T_cw, require positive depth and pixel inside image bounds.

    Returns (visible mask (...,N), uv (...,N,2), z (...,N), ur (...,N)).
    """
    R, t = T_cw[..., :3, :3], T_cw[..., :3, 3]
    pts_c = jnp.einsum("...ij,...nj->...ni", R, pts_w) + t[..., None, :]
    uv, z = project(cam, pts_c)
    ur = u_right(cam, uv[..., 0], z)
    ok = (
        (z > 0.05)
        & (uv[..., 0] >= -margin)
        & (uv[..., 0] < cam.width + margin)
        & (uv[..., 1] >= -margin)
        & (uv[..., 1] < cam.height + margin)
    )
    return ok, uv, z, ur
