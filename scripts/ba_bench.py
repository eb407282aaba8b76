"""Bundle-adjustment throughput: local-BA (Schur) iterations/s and global
sweep rate — the "BA iters/s" leg of the BASELINE metric.

Usage: python scripts/ba_bench.py  (runs on whatever jax.devices() offers)
"""

from __future__ import annotations

import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from aslam.config import BAConfig, CameraModel
    from aslam.ops import lba
    from aslam.utils import camera, se3

    print("devices:", jax.devices(), flush=True)
    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                      width=640, height=480)
    rng = np.random.default_rng(0)

    def build(n_cams, n_pts, obs_per_cam):
        pts = np.stack([
            rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
            rng.uniform(1.5, 4.5, n_pts)
        ], -1).astype(np.float32)
        Ts = []
        for i in range(n_cams):
            xi = np.concatenate([[0.1 * i, 0, 0], rng.normal(0, .01, 3)])
            Ts.append(np.asarray(se3.se3_exp(jnp.asarray(
                xi.astype(np.float32)))))
        Ts = np.stack(Ts)
        e_cam, e_lm, e_uv, e_ur, e_z = [], [], [], [], []
        for c in range(n_cams):
            sel = rng.choice(n_pts, obs_per_cam, replace=False)
            pc = pts[sel] @ Ts[c][:3, :3].T + Ts[c][:3, 3]
            uv, z = camera.project(cam, jnp.asarray(pc))
            uv = np.asarray(uv) + rng.normal(0, 0.3, (obs_per_cam, 2))
            z = np.asarray(z)
            ur = np.asarray(camera.u_right(
                cam, jnp.asarray(uv[:, 0].astype(np.float32)),
                jnp.asarray(z)))
            e_cam += [c] * obs_per_cam
            e_lm += sel.tolist()
            e_uv += uv.tolist()
            e_ur += ur.tolist()
            e_z += z.tolist()
        noisy = pts + rng.normal(0, .02, pts.shape).astype(np.float32)
        return lba.BAProblem(
            cam_T=jnp.asarray(Ts),
            cam_fixed=jnp.asarray(np.arange(n_cams) == 0),
            cam_valid=jnp.ones(n_cams, bool),
            points=jnp.asarray(noisy),
            point_valid=jnp.ones(n_pts, bool),
            e_cam=jnp.asarray(e_cam, jnp.int32),
            e_lm=jnp.asarray(e_lm, jnp.int32),
            e_uv=jnp.asarray(np.asarray(e_uv, np.float32)),
            e_ur=jnp.asarray(np.asarray(e_ur, np.float32)),
            e_z=jnp.asarray(np.asarray(e_z, np.float32)),
            e_valid=jnp.ones(len(e_cam), bool),
        )

    for (C, L, O) in [(16, 2048, 512), (32, 4096, 1024)]:
        prob = build(C, L, O)
        cfg = BAConfig()
        # compile ONE LM iteration; loop host-side (the unrolled schedule
        # compiles far longer)
        it = jax.jit(lambda p: lba.ba_iterate(p, cam, cfg, 1, robust=True))
        out = it(prob)
        jax.block_until_ready(out.cam_T)
        print(f"C={C}: compiled", flush=True)
        n_iters = 20
        t0 = time.time()
        p = prob
        for _ in range(n_iters):
            p = it(p)
            jax.block_until_ready(p.cam_T)
        dt = time.time() - t0
        iters_s = n_iters / dt
        E = len(np.asarray(prob.e_cam))
        print(f"local BA C={C} L={L} E={E}: {iters_s:.1f} LM iters/s "
              f"({dt/n_iters*1000:.1f} ms/iter)", flush=True)


if __name__ == "__main__":
    main()
