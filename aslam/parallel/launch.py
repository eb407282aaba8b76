"""Multi-process (multi-host) launch wiring for distributed BA.

The reference is strictly single-process — no MPI/NCCL/multi-node anywhere
(SURVEY.md §2.3 item 3).  BASELINE config 5 requires BA sharded across >=2
hosts, which in JAX means `jax.distributed.initialize` + a mesh over the
GLOBAL device list; the collectives in parallel/sharded_*.py then lower to
NVLink within a host and the network across hosts with no further code
changes.

Every process passes the cluster explicitly — nothing in a GPU cluster
tells JAX of its peers:
`initialize(coordinator, num_processes, process_id, local_device_ids)`,
or `initialize_from_env()` from the ASLAM_* variables below.

A 2-process CPU run (tests/test_multiprocess.py) exercises the REAL
process-boundary path: two OS processes, a coordination service, global
arrays whose shards live in different processes, and cross-process
collectives — everything a multi-host run needs except the interconnect.
"""

from __future__ import annotations

import os
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from aslam.parallel.mesh import factor_devices


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
) -> None:
    """Join the multi-process runtime.  Call exactly once per process,
    before any other JAX API touches the backend."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def initialize_from_env() -> bool:
    """Initialize from ASLAM_COORDINATOR / ASLAM_NUM_PROCESSES /
    ASLAM_PROCESS_ID, or no-op-return False when unset (single-process
    runs)."""
    coord = os.environ.get("ASLAM_COORDINATOR")
    if not coord:
        return False
    initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["ASLAM_NUM_PROCESSES"]),
        process_id=int(os.environ["ASLAM_PROCESS_ID"]),
    )
    return True


def global_mesh(dp: int | None = None, lm: int | None = None) -> Mesh:
    """Mesh over the GLOBAL device list (all processes).  Axes as in
    parallel/mesh.py: 'dp' over BA edges, 'lm' over landmark shards.
    Device order groups each process's devices contiguously along 'dp'
    first, so the high-traffic 'lm' collectives (psum_scatter/all_gather of
    landmark blocks) stay within a process/host where possible."""
    devices = jax.devices()  # global, ordered by process_index
    n = len(devices)
    if dp is None or lm is None:
        dp, lm = factor_devices(n)
    assert dp * lm == n, f"mesh {dp}x{lm} != {n} global devices"
    arr = np.asarray(devices).reshape(dp, lm)
    return Mesh(arr, axis_names=("dp", "lm"))


def process_info() -> tuple[int, int]:
    return jax.process_index(), jax.process_count()


def shard_problem(prob, mesh: Mesh):
    """Build GLOBAL jax.Arrays for a BAProblem from host-replicated numpy
    data (every process holds the full problem; each contributes only its
    addressable shards).  Cameras/points replicate; edges shard over all
    mesh axes — the layout sharded_local_ba's shard_map expects.

    In single-process runs this is equivalent to plain device_put and the
    existing virtual-mesh tests keep working; in multi-process runs it is
    REQUIRED (a single-device local array cannot be auto-resharded across
    process boundaries)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    edge1 = NamedSharding(mesh, P(("dp", "lm")))
    edge2 = NamedSharding(mesh, P(("dp", "lm"), None))

    def put(x, s):
        return jax.device_put(np.asarray(x), s)

    return prob._replace(
        cam_T=put(prob.cam_T, rep),
        cam_fixed=put(prob.cam_fixed, rep),
        cam_valid=put(prob.cam_valid, rep),
        points=put(prob.points, rep),
        point_valid=put(prob.point_valid, rep),
        e_cam=put(prob.e_cam, edge1),
        e_lm=put(prob.e_lm, edge1),
        e_uv=put(prob.e_uv, edge2),
        e_ur=put(prob.e_ur, edge1),
        e_z=put(prob.e_z, edge1),
        e_valid=put(prob.e_valid, edge1),
    )
