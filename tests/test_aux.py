"""Auxiliary subsystems: checkpoint/resume, viewer, metrics, DBSCAN,
homography/evaluation tools."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import small_config
from aslam.ops import dbscan
from aslam.utils import checkpoint, evaluation, metrics


def test_checkpoint_roundtrip(tmp_path):
    from tests.test_slam_synthetic import run_system

    slam, _ = run_system(n_frames=5)
    path = str(tmp_path / "map.npz")
    checkpoint.save_system(path, slam)

    slam2, _ = run_system(n_frames=2)  # different state
    checkpoint.load_system(path, slam2)
    assert slam2.tracking.n_kfs == slam.tracking.n_kfs
    for f in slam.map._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(slam.map, f)),
            np.asarray(getattr(slam2.map, f)),
            err_msg=f,
        )


def test_viewer_renders(tmp_path):
    from aslam.utils import viewer
    from tests.test_slam_synthetic import run_system

    slam, _ = run_system(n_frames=5)
    hud = viewer.hud_counters(slam)
    assert hud["keyframes"] >= 1 and hud["landmarks"] > 0
    path = str(tmp_path / "map.png")
    viewer.render_map(slam, path)
    assert os.path.getsize(path) > 5000


def test_metrics_timers():
    m = metrics.Metrics()
    with m.timer("stage"):
        x = jnp.ones((64, 64)) * 2
    with m.timer("stage", sync=x):
        pass
    m.count("frames", 3)
    m.record("ate", 0.01)
    s = m.summary()
    assert s["timers"]["stage"]["n"] == 2
    assert s["counters"]["frames"] == 3


def test_dbscan_clusters_and_noise(rng):
    # two tight clusters + isolated points
    pts = np.concatenate([
        rng.normal([50, 50], 2.0, (20, 2)),
        rng.normal([150, 100], 2.0, (15, 2)),
        [[10, 200], [300, 20], [200, 220]],
    ]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    labels = np.asarray(dbscan.dbscan_labels(
        jnp.asarray(pts), jnp.asarray(valid), eps=10.0, min_pts=3))
    l0 = labels[:20]
    l1 = labels[20:35]
    assert len(np.unique(l0)) == 1 and l0[0] >= 0
    assert len(np.unique(l1)) == 1 and l1[0] >= 0
    assert l0[0] != l1[0]
    assert (labels[35:] == -1).all()


def test_dbscan_decluster_keeps_strongest(rng):
    pts = np.concatenate([
        rng.normal([50, 50], 2.0, (10, 2)),
        [[200, 200]],
    ]).astype(np.float32)
    resp = np.arange(11, dtype=np.float32)
    keep = np.asarray(dbscan.decluster(
        jnp.asarray(pts), jnp.asarray(resp), jnp.ones(11, bool),
        eps=10.0, min_pts=2, keep_per_cluster=1))
    # strongest of the cluster (index 9) survives, the rest die
    assert keep[9] and not keep[:9].any()
    # isolated point survives
    assert keep[10]


def test_homography_dlt_exact(rng):
    H_true = np.array([[1.1, 0.02, 5.0], [-0.03, 0.95, -3.0], [1e-4, -2e-4, 1.0]])
    src = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    dst = np.asarray(evaluation.apply_homography(jnp.asarray(H_true), jnp.asarray(src)))
    H = np.asarray(evaluation.homography_dlt(
        jnp.asarray(src), jnp.asarray(dst), jnp.ones(40)))
    np.testing.assert_allclose(H, H_true, atol=1e-3)


def test_homography_ransac_with_outliers(rng):
    H_true = np.array([[1.0, 0.01, 8.0], [0.0, 1.05, -4.0], [0.0, 0.0, 1.0]])
    src = rng.uniform(0, 300, (100, 2)).astype(np.float32)
    dst = np.array(evaluation.apply_homography(jnp.asarray(H_true), jnp.asarray(src)))
    dst[70:] += rng.uniform(30, 80, (30, 2))
    H, inl, n = evaluation.find_homography_ransac(
        jnp.asarray(src), jnp.asarray(dst.astype(np.float32)),
        jnp.ones(100, bool), jax.random.PRNGKey(0))
    assert int(n) >= 65
    proj = np.asarray(evaluation.apply_homography(H, jnp.asarray(src[:70])))
    assert np.linalg.norm(proj - dst[:70], axis=1).max() < 2.0


def test_recall_precision_curve(rng):
    n = 60
    desc1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    desc2 = desc1.copy()  # perfect descriptors
    xy1 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    H = np.eye(3)
    xy2 = xy1.copy()
    ts, recall, precision = evaluation.recall_precision_curve(
        desc1, desc2, xy1, xy2, H)
    assert recall[-1] > 0.99        # everything matched at max threshold
    assert precision[-1] > 0.99     # and correctly
    assert recall[0] <= recall[-1]  # monotone-ish


def test_draw_matches(tmp_path, rng):
    from aslam.utils import viewer

    img1 = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    img2 = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy1 = rng.uniform(10, 150, (30, 2)).astype(np.float32)
    xy2 = rng.uniform(10, 150, (30, 2)).astype(np.float32)
    match_idx = np.arange(30, dtype=np.int32)
    match_idx[10:] = -1
    path = str(tmp_path / "matches.png")
    viewer.draw_matches(img1, xy1, img2, xy2, match_idx, path)
    assert os.path.getsize(path) > 5000


def test_pointcloud_create_and_ply(tmp_path, rng):
    from aslam.config import small_config
    from aslam.utils import pointcloud, synthetic

    cfg = small_config()
    imgs, depths, poses, _ = synthetic.make_sequence(n_frames=1, n_points=200)
    pts, gray = pointcloud.create_cloud(
        np.array(depths[0]), cfg.camera, poses[0], np.array(imgs[0]),
        stride=2, voxel=0.05)
    assert len(pts) > 50
    assert gray is not None and len(gray) == len(pts)
    # voxel thinning: no two points share a voxel
    vox = np.floor(pts / 0.05).astype(int)
    # world-frame transform applied (identity pose here -> camera frame)
    path = str(tmp_path / "cloud.ply")
    pointcloud.save_ply(path, pts, gray)
    head = open(path).read(200)
    assert head.startswith("ply") and "element vertex" in head


def test_statistical_outlier_filter(rng):
    from aslam.utils import pointcloud

    pts = np.concatenate([
        rng.normal(0, 0.1, (200, 3)),
        [[5.0, 5.0, 5.0]],   # far outlier
    ]).astype(np.float32)
    keep = pointcloud.statistical_outlier_filter(pts, k=8, std_ratio=1.0)
    assert not keep[-1]
    assert keep[:200].mean() > 0.8


def test_xla_trace_smoke(tmp_path):
    import jax.numpy as jnp

    with metrics.xla_trace(str(tmp_path / "trace")):
        (jnp.ones((32, 32)) * 2).block_until_ready()
    # a trace directory with content was produced
    produced = list((tmp_path / "trace").rglob("*"))
    assert produced, "no profiler output written"


def test_dbscan_chain_merge(rng):
    """Two dense blobs connected by a chain of core points must merge."""
    blob1 = rng.normal([20, 20], 1.5, (12, 2))
    blob2 = rng.normal([60, 20], 1.5, (12, 2))
    chain = np.stack([np.linspace(22, 58, 10), np.full(10, 20.0)], -1)
    # make chain points core: duplicate each with a small offset
    chain2 = chain + [0.5, 0.5]
    pts = np.concatenate([blob1, blob2, chain, chain2]).astype(np.float32)
    import jax.numpy as jnp

    labels = np.asarray(dbscan.dbscan_labels(
        jnp.asarray(pts), jnp.ones(len(pts), bool), eps=6.0, min_pts=3))
    assert (labels >= 0).all()
    assert len(np.unique(labels)) == 1, "chained clusters failed to merge"


def test_web_viewer_serves_state():
    """Live web viewer (Pangolin replacement): HTML page + JSON state."""
    import json
    import urllib.request

    import jax.numpy as jnp

    from aslam.config import small_config
    from aslam.models import mapstate as ms
    from aslam.utils.webviewer import WebViewer

    cfg = small_config()
    m = ms.init_map(cfg)
    m = m._replace(
        kf_T_cw=m.kf_T_cw.at[0].set(jnp.eye(4)),
        kf_valid=m.kf_valid.at[0].set(True),
        lm_pos=m.lm_pos.at[:3].set(jnp.asarray([[0., 0., 2.], [1., 0., 2.],
                                                [0., 1., 3.]])),
        lm_valid=m.lm_valid.at[:3].set(True),
    )
    v = WebViewer(port=0)
    try:
        v.update(m, traj=np.eye(4)[None], stats={"keyframes": 1, "fps": 123.4})
        page = urllib.request.urlopen(v.url, timeout=10).read().decode()
        assert "aslam live map" in page
        st = json.loads(urllib.request.urlopen(
            v.url + "state", timeout=10).read())
        assert len(st["landmarks"]) == 3
        assert len(st["kfs"]) == 1
        assert st["stats"]["keyframes"] == 1
        assert st["seq"] >= 1
        # 404 for unknown path
        import urllib.error
        try:
            urllib.request.urlopen(v.url + "nope", timeout=10)
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
        # second update bumps seq
        v.update(stats={"keyframes": 2})
        st2 = json.loads(urllib.request.urlopen(
            v.url + "state", timeout=10).read())
        assert st2["seq"] == st["seq"] + 1
        assert st2["landmarks"] == st["landmarks"]  # retained
    finally:
        v.stop()


def test_webviewer_serves_kf_fwd():
    """The 3-D orbit page needs per-KF viewing directions: kf_fwd must be
    the world-frame camera forward (row 2 of R == R^T @ e_z)."""
    import json
    import urllib.request

    import jax.numpy as jnp

    from aslam.config import small_config
    from aslam.models import mapstate as ms
    from aslam.utils.webviewer import WebViewer

    cfg = small_config()
    m = ms.init_map(cfg)
    th = 0.5
    R = np.array([[np.cos(th), 0, np.sin(th)],
                  [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    m = m._replace(
        kf_T_cw=m.kf_T_cw.at[0].set(jnp.asarray(T)),
        kf_valid=m.kf_valid.at[0].set(True),
    )
    v = WebViewer(port=0)
    try:
        v.update(m)
        st = json.loads(urllib.request.urlopen(
            v.url + "state", timeout=10).read())
        fwd = np.asarray(st["kf_fwd"][0])
        np.testing.assert_allclose(fwd, R.T @ np.array([0, 0, 1.0]),
                                   atol=1e-3)
        # orbit page markers present
        page = urllib.request.urlopen(v.url, timeout=10).read().decode()
        assert "orbit" in page and "kf_fwd" in page
    finally:
        v.stop()
