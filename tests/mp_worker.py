"""Worker process for tests/test_multiprocess.py: joins a 2-process
jax.distributed CPU cluster (4 virtual devices per process -> 8 global),
runs the sharded local-BA schedule over the GLOBAL mesh, and checks the
result against the single-device solver computed locally.

This exercises the real multi-host path of BASELINE config 5 — process
boundaries, coordination service, global arrays with remote shards,
cross-process collectives — on one machine (SURVEY.md §4: multi-host tests
via jax.distributed with simulated topology).

Invoked as:  python tests/mp_worker.py --coordinator HOST:PORT --nproc N --pid I
"""

from __future__ import annotations

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    sys.path.insert(0, os.path.join(repo, "tests"))

    import jax

    from aslam.parallel import launch

    launch.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nproc,
        process_id=args.pid,
    )
    assert jax.process_count() == args.nproc, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == args.nproc * n_local, (n_global, n_local)

    import numpy as np

    from aslam.ops import lba
    from aslam.parallel import sharded_ba
    from test_lba import CAM, CFG, make_ba_problem

    # identical deterministic problem on every process
    prob, T_true, pts_true, _ = make_ba_problem(
        np.random.default_rng(7), n_cams=5, n_pts=64)

    mesh = launch.global_mesh()  # over all 8 global devices
    padded = sharded_ba.pad_problem(prob, mesh)
    gprob = launch.shard_problem(padded, mesh)
    out, chi2, n_edges = sharded_ba.sharded_local_ba(gprob, CAM, CFG, mesh)

    # replicated outputs are fully addressable on every process
    cam_T = np.asarray(out.cam_T)
    points = np.asarray(out.points)[:64]
    chi2 = float(chi2)
    n_edges = int(n_edges)

    # single-process reference (local single-device computation)
    ref_out, ref_stats = lba.local_ba(prob, CAM, CFG)
    np.testing.assert_allclose(cam_T, np.asarray(ref_out.cam_T), atol=1e-3)
    np.testing.assert_allclose(points, np.asarray(ref_out.points), atol=1e-3)
    assert n_edges == int(ref_stats.n_edges), (n_edges, int(ref_stats.n_edges))
    assert np.isclose(chi2, float(ref_stats.chi2), rtol=0.05), (
        chi2, float(ref_stats.chi2))

    print(f"MP_OK pid={jax.process_index()}/{jax.process_count()} "
          f"devices={n_global} chi2={chi2:.4f} edges={n_edges}", flush=True)


if __name__ == "__main__":
    main()
