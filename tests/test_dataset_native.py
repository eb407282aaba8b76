"""Dataset loading: TUM association parsing, native PNG decode, prefetch."""

import os

import numpy as np
import pytest

from aslam.utils import dataset, png


@pytest.fixture
def tum_dir(tmp_path, rng):
    """Synthesize a mini TUM sequence directory."""
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    lines = []
    for i in range(4):
        t = 1305031102.0 + 0.033 * i
        rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        depth = rng.integers(0, 20000, (48, 64), dtype=np.uint16)
        png.write_png(str(tmp_path / "rgb" / f"{t:.6f}.png"), rgb)
        png.write_png(str(tmp_path / "depth" / f"{t:.6f}.png"), depth)
        lines.append(f"{t:.6f} rgb/{t:.6f}.png {t:.6f} depth/{t:.6f}.png")
    (tmp_path / "associations.txt").write_text(
        "# comment line\n" + "\n".join(lines) + "\n"
    )
    return str(tmp_path)


def test_associations_parse(tum_dir):
    a = dataset.load_associations(tum_dir)
    assert len(a.rgb_paths) == 4
    assert a.timestamps[1] > a.timestamps[0]
    assert os.path.exists(a.rgb_paths[0])


def test_sequence_loads_frames(tum_dir):
    seq = dataset.TumSequence(tum_dir)
    assert len(seq) == 4
    t, img, depth = seq[0]
    assert img.shape == (48, 64) and img.dtype == np.float32
    assert 0 <= img.min() and img.max() <= 255
    assert depth.shape == (48, 64) and depth.dtype == np.float32
    assert depth.max() <= 20000 / 5000.0 + 1e-6
    seq.close()


def test_sequence_prefetch_matches_sync(tum_dir):
    seq_sync = dataset.TumSequence(tum_dir, lookahead=0)
    seq_pre = dataset.TumSequence(tum_dir, lookahead=3)
    for i in range(4):
        t1, i1, d1 = seq_sync[i]
        t2, i2, d2 = seq_pre[i]
        assert t1 == t2
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)
    seq_pre.close()


def test_native_loader_used_when_built(tum_dir):
    from aslam.native import loader

    if not loader.available():
        pytest.skip("native library not built")
    a = dataset.load_associations(tum_dir)
    out = loader.decode_png(a.depth_paths[0])
    assert out is not None and out.dtype == np.uint16


def test_associate_nearest():
    rgb = [(0.00, "r0"), (0.03, "r1"), (0.06, "r2")]
    depth = [(0.001, "d0"), (0.032, "d1"), (0.20, "d2")]
    out = dataset.associate(rgb, depth, max_dt=0.02)
    assert [(r, d) for _, r, d in out] == [("r0", "d0"), ("r1", "d1")]


def test_native_prefetcher_matches_sync(tum_dir):
    """C++ worker-thread prefetch (native/prefetcher.cpp) must produce the
    same frames as synchronous loads, in order, on rewind, and on seek."""
    from aslam.native.loader import NativePrefetcher

    if not NativePrefetcher.create(["x"], ["x"]):
        import aslam.native.loader as loader

        if not loader.available():
            pytest.skip("native library not built")
    a = dataset.load_associations(tum_dir)
    pf = NativePrefetcher.create(a.rgb_paths, a.depth_paths,
                                 lookahead=2, workers=2)
    if pf is None:
        pytest.skip("native prefetcher unavailable")
    try:
        for i in range(len(a.rgb_paths)):
            rgb, dep = pf.get(i)
            assert rgb.dtype == np.uint8 and dep.dtype == np.uint16
        # seek forward (skips 1..2), then rewind behind the window
        pf2 = NativePrefetcher.create(a.rgb_paths, a.depth_paths,
                                      lookahead=2, workers=2)
        r3, d3 = pf2.get(3)
        r0, d0 = pf2.get(0)
        sync = dataset.TumSequence(tum_dir, lookahead=0)
        _, i0, z0 = sync[0]
        _, i3, z3 = sync[3]
        exp0 = (0.299 * r0[..., 0] + 0.587 * r0[..., 1]
                + 0.114 * r0[..., 2]).astype(np.float32)
        exp3 = (0.299 * r3[..., 0] + 0.587 * r3[..., 1]
                + 0.114 * r3[..., 2]).astype(np.float32)
        np.testing.assert_allclose(exp0, i0, atol=1e-4)
        np.testing.assert_allclose(exp3, i3, atol=1e-4)
        # multiply by the reciprocal exactly as load_depth does (x*(1/5000)
        # and x/5000 differ by one f32 ulp)
        np.testing.assert_array_equal(
            d0.astype(np.float32) * np.float32(1.0 / 5000.0), z0)
        np.testing.assert_array_equal(
            d3.astype(np.float32) * np.float32(1.0 / 5000.0), z3)
        pf2.close()
    finally:
        pf.close()


def test_sequence_native_pipeline_matches_python(tum_dir):
    """TumSequence must yield identical frames whether the native pipeline,
    the Python thread pool, or synchronous loading serves them."""
    import aslam.native.loader as loader

    if not loader.available():
        pytest.skip("native library not built")
    seq_nat = dataset.TumSequence(tum_dir, lookahead=3)
    seq_sync = dataset.TumSequence(tum_dir, lookahead=0)
    assert seq_nat._native is not None  # native path actually selected
    for i in range(len(seq_sync)):
        t1, i1, d1 = seq_nat[i]
        t2, i2, d2 = seq_sync[i]
        assert t1 == t2
        np.testing.assert_allclose(i1, i2, atol=1e-4)
        np.testing.assert_array_equal(d1, d2)
    seq_nat.close()
