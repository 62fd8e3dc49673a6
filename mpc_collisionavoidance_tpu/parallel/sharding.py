"""Scenario-batch data parallelism over a device mesh.

The reference runs ONE solve per control tick on one CPU core and its only
"distributed" mechanism is ROS pub/sub between processes (SURVEY.md
section 2.3).  Here scale comes from the device program's own axes:

- on-chip: `jax.vmap` turns the RTI step into a batched tensor program
  (thousands of independent OCP instances per chip),
- across chips/hosts: the batch axis is sharded over a 1-D
  `jax.sharding.Mesh` ("dp"); each solve is embarrassingly parallel, so the
  only collectives are fleet-level reductions (convergence voting, global
  metrics) done with `jax.lax.psum` inside `shard_map` — these ride NVLink
  within a host, and the network via `jax.distributed` for multi-host
  meshes.

No NCCL/MPI analog is needed: XLA inserts the collectives from sharding
annotations (scaling-book recipe: pick a mesh, annotate, let XLA do layout).
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver


def make_mesh(n_devices: Optional[int] = None, devices=None,
              axis_name: str = "dp") -> Mesh:
    """1-D data-parallel mesh over the scenario batch axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(mesh: Mesh, tree, axis_name: str = "dp"):
    """Place a pytree of batched arrays with the batch axis sharded."""

    def put(x):
        spec = P(axis_name, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def make_sharded_batch_solver(solver: RTISolver, mesh: Mesh,
                              axis_name: str = "dp", donate: bool = True):
    """Jitted batched RTI step with the scenario axis sharded over `mesh`.

    Returns ``step(states, x0s, params, lhs) -> (states, outs)`` where every
    leading axis is the (sharded) batch axis.  XLA partitions the whole
    program along the batch axis; no cross-instance communication exists in
    the solve itself, so scaling is linear up to batch//devices granularity.
    """
    batched = jax.vmap(solver.step_fn)
    # sharding follows the inputs: callers place the batch axis over the
    # mesh with `shard_batch`, and jit propagates those shardings (no
    # explicit in_shardings needed for this embarrassingly parallel step)
    step = jax.jit(batched, donate_argnums=(0,) if donate else ())

    def run(states, x0s, params, lhs=None):
        args = (states, x0s, params) if lhs is None else (states, x0s, params, lhs)
        return step(*args)

    return run


def fleet_metrics(mesh: Mesh, statuses: jnp.ndarray, gaps: jnp.ndarray,
                  axis_name: str = "dp"):
    """Global fleet health reduction (the 'convergence voting' collective):
    fraction of converged instances and max duality gap across ALL shards.

    Runs as a `shard_map` with explicit `psum`/`pmax`, i.e. the collective
    rides ICI between chips rather than gathering to host.
    """
    from jax.experimental.shard_map import shard_map

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis_name), P(axis_name)),
             out_specs=(P(), P()))
    def reduce_(st, gp):
        n_ok = jnp.sum((st == 0).astype(jnp.float32))
        n = jnp.asarray(st.shape[0], jnp.float32)
        frac = jax.lax.psum(n_ok, axis_name) / jax.lax.psum(n, axis_name)
        gmax = jax.lax.pmax(jnp.max(gp), axis_name)
        return frac[None], gmax[None]

    frac, gmax = reduce_(statuses, gaps)
    return frac[0], gmax[0]
