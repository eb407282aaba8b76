"""Alternate detector/descriptor families (reference extractor.h:8-25 enum
algebra): response localization, adaptive control, descriptor invariances,
and the L2 float-descriptor matcher path."""

import jax.numpy as jnp
import numpy as np
import pytest

from aslam.config import ExtractorConfig
from aslam.models.extractor import detector_params, extract_features
from aslam.ops import desc as desc_ops
from aslam.ops import detectors, fast, hamming, matching
from aslam.ops.orb import unpack_bits


# ---------------------------------------------------------------- fixtures

def checkerboard(h=120, w=160, sq=20, lo=40.0, hi=220.0):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.where(((ys // sq) + (xs // sq)) % 2 == 0, lo, hi)
    return img.astype(np.float32)


def blob_image(h=120, w=160, centers=((40, 50), (80, 110)), sigma=3.0):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.full((h, w), 60.0)
    for (cy, cx) in centers:
        img += 160.0 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))
    return img.astype(np.float32)


def textured(h=160, w=200, seed=3):
    """Smooth random texture with enough structure for every detector."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img += rng.normal(0, 2.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def _peaks(resp):
    r = np.asarray(fast.nms_3x3(jnp.asarray(resp)))
    ys, xs = np.nonzero(r > 0)
    order = np.argsort(-r[ys, xs])
    return np.stack([ys[order], xs[order]], axis=1)


def rotate_image(img: np.ndarray, angle_rad: float) -> np.ndarray:
    """Bilinear rotation about the image center (numpy, test-only)."""
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ca, sa = np.cos(-angle_rad), np.sin(-angle_rad)
    sx = cx + (xs - cx) * ca - (ys - cy) * sa
    sy = cy + (xs - cx) * sa + (ys - cy) * ca
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    return out.astype(np.float32)


def rotate_points(xy: np.ndarray, angle_rad: float, h: int, w: int) -> np.ndarray:
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = np.cos(angle_rad), np.sin(angle_rad)
    x = cx + (xy[:, 0] - cx) * ca - (xy[:, 1] - cy) * sa
    y = cy + (xy[:, 0] - cx) * sa + (xy[:, 1] - cy) * ca
    return np.stack([x, y], axis=1)


# ---------------------------------------------------------------- detectors

def test_corner_detectors_localize_checkerboard():
    # X-corners: GFTT/HARRIS territory.  (FAST-9 correctly does NOT fire on
    # ideal X-corners — the bright/dark ring arcs are exactly 8 long.)
    img = jnp.asarray(checkerboard())
    true = [
        (y, x)
        for y in range(20, 120, 20)
        for x in range(20, 160, 20)
        if 8 <= y < 112 and 8 <= x < 152
    ]
    for name in ["GFTT", "HARRIS"]:
        d = detectors.defaults(name)
        peaks = _peaks(detectors.response(name, img, d["threshold"]))
        assert len(peaks) >= 10, name
        hits = 0
        for (py, px) in peaks[:40]:
            if any(abs(py - ty) <= 2 and abs(px - tx) <= 2 for ty, tx in true):
                hits += 1
        assert hits / min(len(peaks), 40) > 0.8, (name, hits)


def test_fast_localizes_l_corners():
    # isolated bright squares: each corner is an L-corner with a ~12-long
    # darker ring arc, squarely in FAST-9's firing regime
    img_np = np.full((120, 160), 40.0, np.float32)
    true = []
    for cy in range(20, 120, 40):
        for cx in range(20, 160, 40):
            img_np[cy : cy + 14, cx : cx + 14] = 220.0
            true += [
                (cy, cx), (cy, cx + 13), (cy + 13, cx), (cy + 13, cx + 13)
            ]
    peaks = _peaks(detectors.response("FAST", jnp.asarray(img_np), 20.0))
    assert len(peaks) >= 10
    hits = sum(
        1
        for (py, px) in peaks
        if any(abs(py - ty) <= 2 and abs(px - tx) <= 2 for ty, tx in true)
    )
    assert hits / len(peaks) > 0.8, hits


def test_blob_detectors_localize_blobs():
    centers = ((40, 50), (80, 110))
    img = jnp.asarray(blob_image(centers=centers))
    for name in ["DOG", "HESSIAN", "STAR"]:
        d = detectors.defaults(name)
        peaks = _peaks(detectors.response(name, img, d["threshold"]))
        assert len(peaks) >= 1, name
        for (cy, cx) in centers:
            dist = np.min(np.hypot(peaks[:, 0] - cy, peaks[:, 1] - cx))
            assert dist <= 3.0, (name, dist)


def test_detector_aliases_and_unknown():
    assert detectors.canonical("ORB_SLAM2") == "FAST"
    assert detectors.canonical("BRISK") == "FAST"
    assert detectors.canonical("SIFT") == "DOG"
    assert detectors.canonical("surf") == "HESSIAN"
    with pytest.raises(ValueError):
        detectors.canonical("NOPE")
    assert desc_ops.canonical("ORB_SLAM2") == "ORB"
    assert desc_ops.canonical("BRISK") == "FREAK"
    assert not desc_ops.is_binary("SURF")
    assert desc_ops.is_binary("LATCH")
    with pytest.raises(ValueError):
        desc_ops.canonical("NOPE")


def test_detector_params_dispatch():
    cfg = ExtractorConfig()
    assert detector_params(cfg) == (20.0, 2.0, 80.0)
    th0, lo, hi = detector_params(ExtractorConfig(detector="GFTT"))
    assert (th0, lo, hi) == (15.0, 1.5, 120.0)


def test_adaptive_controller_moves_gftt_threshold():
    img = jnp.asarray(textured())
    name = "GFTT"
    # absurdly high threshold -> zero detections -> tooFew must lower it
    high = jnp.full((3, 3), 100.0)
    counts = fast.counts_per_grid_cell(
        fast.nms_3x3(detectors.response(name, img, fast.threshold_map_from_grid(high, 160, 200))), 3, 3
    )
    upd = fast.adaptive_threshold_update(
        high, counts, min_count=10, max_count=100, th_min=1.5, th_max=120.0
    )
    assert np.all(np.asarray(upd) < np.asarray(high))


# -------------------------------------------------------------- descriptors

def _kps(img: np.ndarray, n=80, border=18):
    """Strong, well-interior corner locations on a textured image."""
    peaks = _peaks(detectors.response("GFTT", jnp.asarray(img), 8.0))
    h, w = img.shape
    sel = [
        (x, y)
        for (y, x) in peaks
        if border <= y < h - border and border <= x < w - border
    ][:n]
    return np.asarray(sel, np.float32)


ALL_DESCS = ["ORB", "BRIEF", "FREAK", "LATCH", "SIFT"]


@pytest.mark.parametrize("name", ALL_DESCS)
def test_descriptor_shape_determinism_shift(name):
    img = textured()
    xy = _kps(img)
    assert len(xy) >= 30
    d1, a1 = desc_ops.describe(name, jnp.asarray(img), jnp.asarray(xy))
    d1b, _ = desc_ops.describe(name, jnp.asarray(img), jnp.asarray(xy))
    if name == "SIFT":
        assert d1.shape == (len(xy), 128) and d1.dtype == jnp.float32
        norms = np.linalg.norm(np.asarray(d1), axis=1)
        assert np.all(norms < 1.01) and np.median(norms) > 0.8
    else:
        assert d1.shape == (len(xy), 8) and d1.dtype == jnp.uint32
    assert np.array_equal(np.asarray(d1), np.asarray(d1b))

    # integer translation: descriptors at shifted coords on the shifted image
    # must be (near-)identical — sampling grids translate exactly
    sy, sx = 7, 11
    img2 = np.roll(img, (sy, sx), axis=(0, 1))
    d2, _ = desc_ops.describe(
        name, jnp.asarray(img2), jnp.asarray(xy + np.array([sx, sy], np.float32))
    )
    if name == "SIFT":
        dist = np.linalg.norm(np.asarray(d1) - np.asarray(d2), axis=1)
        assert np.median(dist) < 0.25
    else:
        ham = np.asarray(
            hamming.distance_matrix_popcount(d1, d2)
        ).diagonal()
        assert np.median(ham) <= 8, (name, np.median(ham))


@pytest.mark.parametrize("name", ["ORB", "FREAK", "LATCH", "SIFT"])
def test_steered_descriptors_survive_rotation(name):
    """Rotation-steered families must match their rotated selves far better
    than chance (random Hamming = 128 bits / random L2 ~ sqrt(2))."""
    img = textured(seed=7)
    h, w = img.shape
    ang = np.deg2rad(25.0)
    img_r = rotate_image(img, ang)
    xy = _kps(img, n=60, border=30)
    xy_r = rotate_points(xy, ang, h, w)
    keep = (
        (xy_r[:, 0] > 18) & (xy_r[:, 0] < w - 18)
        & (xy_r[:, 1] > 18) & (xy_r[:, 1] < h - 18)
    )
    xy, xy_r = xy[keep], xy_r[keep]
    assert len(xy) >= 20
    d1, _ = desc_ops.describe(name, jnp.asarray(img), jnp.asarray(xy))
    d2, _ = desc_ops.describe(name, jnp.asarray(img_r), jnp.asarray(xy_r))
    if name == "SIFT":
        dist = np.median(np.linalg.norm(np.asarray(d1) - np.asarray(d2), axis=1))
        assert dist < 0.9, dist
    else:
        ham = np.median(
            np.asarray(hamming.distance_matrix_popcount(d1, d2)).diagonal()
        )
        assert ham < 70, (name, ham)


def test_brief_is_not_steered():
    """BRIEF ignores orientation by construction: descriptors must be
    invariant to the reported angle (same input -> same bits regardless)."""
    img = textured(seed=9)
    xy = _kps(img, n=40)
    d, a = desc_ops.describe("BRIEF", jnp.asarray(img), jnp.asarray(xy))
    # angles are reported (API parity) but bits come from unrotated pattern:
    # check bits equal the ORB path evaluated at angle 0
    from aslam.ops.orb import brief_descriptors, extract_patches, pack_bits

    patches = extract_patches(jnp.asarray(img), jnp.asarray(xy))
    expect = pack_bits(brief_descriptors(patches, jnp.zeros(len(xy))))
    assert np.array_equal(np.asarray(d), np.asarray(expect))
    assert np.any(np.abs(np.asarray(a)) > 0.1)  # angles still measured


# ------------------------------------------------------------- L2 matching

def test_l2_distance_matrix_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(17, 128)).astype(np.float32)
    b = rng.normal(size=(23, 128)).astype(np.float32)
    got = np.asarray(hamming.l2_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    want = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_knn_ratio_match_float_descriptors():
    img = textured(seed=11)
    xy = _kps(img, n=60)
    d1, _ = desc_ops.describe("SIFT", jnp.asarray(img), jnp.asarray(xy))
    sy, sx = 5, 9
    img2 = np.roll(img, (sy, sx), axis=(0, 1))
    xy2 = xy + np.array([sx, sy], np.float32)
    perm = np.random.default_rng(1).permutation(len(xy))
    d2, _ = desc_ops.describe("SIFT", jnp.asarray(img2), jnp.asarray(xy2[perm]))
    m = matching.knn_ratio_match(
        d1, jnp.ones(len(xy), bool), d2, jnp.ones(len(xy), bool),
        ratio=0.9, max_dist=0.8,
    )
    tgt = np.asarray(m.target_idx)
    ok = np.asarray(m.valid)
    assert ok.sum() >= 0.5 * len(xy)
    # matched index must invert the permutation
    correct = perm[tgt[ok]] == np.nonzero(ok)[0]
    assert correct.mean() > 0.9


# ------------------------------------------------------- facade integration

@pytest.mark.parametrize("det,desc", [("GFTT", "BRIEF"), ("DOG", "SIFT")])
def test_extract_features_alternate_families(det, desc):
    cfg = ExtractorConfig(
        detector=det, descriptor=desc, n_levels=3, max_keypoints=256,
        adaptive_iters=2, n_features=250,
    )
    img = jnp.asarray(textured(h=192, w=256, seed=13))
    feats, st = extract_features(img, cfg)
    feats2, st2 = extract_features(img, cfg, st)
    n = int(feats2.valid.sum())
    assert n >= 30
    if desc == "SIFT":
        assert feats2.desc.shape[-1] == 128
    else:
        assert feats2.desc.dtype == jnp.uint32
    # valid keypoints stay inside the image
    xy = np.asarray(feats2.xy)[np.asarray(feats2.valid)]
    assert np.all(xy >= 0) and np.all(xy[:, 0] < 256) and np.all(xy[:, 1] < 192)
