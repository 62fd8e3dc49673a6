"""Multi-host (pod-slice) scale-out helpers.

The reference's only cross-process transport is single-host ROS pub/sub
(SURVEY.md section 2.3).  The scale-out story here: each host runs this
same program, `jax.distributed` wires the control plane, the scenario
batch axis is sharded over the GLOBAL device set, and the only cross-card
traffic is the fleet-metric collectives (psum/pmax over NVLink within a
host, the network between hosts) from `parallel/sharding.py`.

Usage on each host of an N-host slice (or under a scheduler that sets
the standard JAX env vars):

    from mpc_collisionavoidance_tpu.parallel import distributed
    distributed.init()                      # no-op on single process
    mesh = distributed.global_scenario_mesh()
    # shard_batch / make_sharded_batch_solver as on one host
"""

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> int:
    """Initialize jax.distributed; safe to call on a single process.

    With no arguments, relies on JAX's cluster autodetection (e.g. slurm);
    a host that no scheduler describes needs `coordinator_address`
    (`host:port`), `num_processes` and `process_id`.  Returns the process
    index.  Idempotent.
    """
    global _initialized
    explicit_single = (num_processes == 1 or
                       (num_processes is None and coordinator_address is None
                        and jax.process_count() == 1))
    if not _initialized and not explicit_single:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
        _initialized = True
    return jax.process_index()


def global_scenario_mesh(axis_name: str = "dp",
                         platform: Optional[str] = None) -> Mesh:
    """1-D mesh over every device of every participating process.

    The scenario batch is embarrassingly parallel, so one flat axis is the
    right shape regardless of the physical topology — XLA still routes the
    psum reductions over NVLink within a host and the network across
    hosts.

    `platform` selects the device kind; when None it follows the user's
    `jax_default_device` pin if set (so sessions pinned to CPU get a CPU
    mesh rather than whatever platform sorts first), else the default
    backend.
    """
    if platform is None:
        default = jax.config.jax_default_device
        if default is not None:
            platform = default.platform
    devices = jax.devices(platform) if platform else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch_global(mesh: Mesh, tree, axis_name: str = "dp"):
    """Multi-process version of `sharding.shard_batch`: assemble GLOBAL
    batch-sharded arrays from each process's local shard.

    Each process passes its LOCAL slice (shape (B_local, ...)); the result
    is a global array of shape (B_local * process_count, ...) with the
    batch axis sharded over the full mesh.  On a single process this
    degrades to exactly `shard_batch`.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        x = np.asarray(x)
        sharding = NamedSharding(
            mesh, P(axis_name, *([None] * (x.ndim - 1))))
        return jax.make_array_from_process_local_data(sharding, x)

    return jax.tree.map(put, tree)


def per_process_batch(global_batch: int) -> int:
    """Split a global scenario count into this process's share (equal
    shards; global_batch must divide evenly for fixed shapes)."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n
