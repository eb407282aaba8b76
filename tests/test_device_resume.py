"""DeviceSlam mid-session checkpoint/resume: a resumed session must
continue bit-for-bit (same device state, trajectory buffers, culled-KF
registry) — the config-5 long-run requirement (SURVEY §5: the reference
has no persistence at all)."""

import numpy as np

from aslam.config import small_config
from aslam.models.device_slam import DeviceSlam
from aslam.utils import synthetic


def test_device_session_resume(tmp_path):
    cfg = small_config()
    cam = cfg.camera
    imgs, deps, poses, _ = synthetic.make_sequence(
        n_frames=24, n_points=400, cam=cam, seed=2)
    dev = DeviceSlam(cfg, seed=0, sync_every=8)
    for i in range(12):
        dev.process(imgs[i], deps[i], t=i * 0.03)
    prefix = str(tmp_path / "ck")
    dev.save(prefix)
    dev2 = DeviceSlam.resume(prefix, cfg, seed=0, sync_every=8)
    for i in range(12, 24):
        dev.process(imgs[i], deps[i], t=i * 0.03)
        dev2.process(imgs[i], deps[i], t=i * 0.03)
    t1, _ = dev.finish()
    t2, _ = dev2.finish()
    assert np.abs(t1 - t2).max() < 1e-4
    r1 = dev.rebuilt_trajectory()
    r2 = dev2.rebuilt_trajectory()
    assert np.abs(r1 - r2).max() < 1e-4
