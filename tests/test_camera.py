import jax.numpy as jnp
import numpy as np

from aslam.config import TUM_FR1, CameraModel
from aslam.utils import camera


SIMPLE = CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)


def test_project_unproject_roundtrip(rng):
    z = rng.uniform(0.5, 4.0, 100).astype(np.float32)
    uv = np.stack([
        rng.uniform(0, 320, 100), rng.uniform(0, 240, 100)
    ], -1).astype(np.float32)
    pts = camera.unproject(SIMPLE, jnp.asarray(uv), jnp.asarray(z))
    uv2, z2 = camera.project(SIMPLE, pts)
    np.testing.assert_allclose(np.asarray(uv2), uv, atol=1e-3)
    np.testing.assert_allclose(np.asarray(z2), z, atol=1e-5)


def test_undistort_inverts_distort(rng):
    cam = TUM_FR1
    # normalized coords in a moderate radius (fr1 distortion is strong)
    xy = rng.uniform(-0.3, 0.3, (200, 2)).astype(np.float32)
    distorted = np.asarray(camera.distort_normalized(cam, jnp.asarray(xy)))
    uv_dist = distorted * np.array([cam.fx, cam.fy]) + np.array([cam.cx, cam.cy])
    uv_undist = np.asarray(camera.undistort_points(cam, jnp.asarray(uv_dist.astype(np.float32))))
    expected = xy * np.array([cam.fx, cam.fy]) + np.array([cam.cx, cam.cy])
    np.testing.assert_allclose(uv_undist, expected, atol=0.1)


def test_undistort_noop_without_distortion():
    uv = jnp.asarray([[10.0, 20.0], [300.0, 200.0]])
    out = camera.undistort_points(SIMPLE, uv)
    np.testing.assert_allclose(np.asarray(out), np.asarray(uv))


def test_u_right():
    z = jnp.asarray([2.0, 0.0, -1.0])
    u = jnp.asarray([100.0, 100.0, 100.0])
    ur = np.asarray(camera.u_right(SIMPLE, u, z))
    assert np.isclose(ur[0], 100.0 - SIMPLE.bf / 2.0)
    assert ur[1] == -1.0 and ur[2] == -1.0


def test_in_frustum(rng):
    pts_w = np.array(
        [[0.0, 0.0, 2.0],   # center, visible
         [0.0, 0.0, -1.0],  # behind
         [10.0, 0.0, 2.0],  # off-image
         [0.0, 0.0, 0.01]], # too close
        np.float32,
    )
    T = jnp.eye(4)
    ok, uv, z, ur = camera.in_frustum(SIMPLE, T, jnp.asarray(pts_w))
    assert list(np.asarray(ok)) == [True, False, False, False]
    np.testing.assert_allclose(np.asarray(uv)[0], [160.0, 120.0], atol=1e-4)
