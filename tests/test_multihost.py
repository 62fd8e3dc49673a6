"""True multi-process jax.distributed test on CPU.

The BASELINE scaling target names 1-chip / 1-host / N>=2-host operation;
single-host sharding is covered on the virtual 8-device mesh elsewhere.
Here TWO separate processes (4 virtual CPU devices each) form one
8-device global mesh via jax.distributed, each contributes its local
scenario shard, one sharded RTI step runs over the global batch, and the
fleet-metric psum/pmax collectives reduce across the process boundary —
the DCN path of a real pod slice, faked on localhost (the analog of the
reference's obstacle-simulator multi-node smoke, SURVEY.md section 4.2).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
proc_id, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax
import jax.numpy as jnp
import numpy as np

from mpc_collisionavoidance_tpu.ocp import builders
from mpc_collisionavoidance_tpu.parallel import (distributed, fleet_metrics,
                                                 make_sharded_batch_solver)
from mpc_collisionavoidance_tpu.sim import scenarios
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver

distributed.init(coordinator_address=coord, num_processes=nproc,
                 process_id=proc_id)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()

mesh = distributed.global_scenario_mesh()
solver = RTISolver(builders.usv_guidance_ca1(Tf=0.4, N=8), ipm_iters=4)
sc = scenarios.guidance_ca1_default()

B_global = 16
B_local = distributed.per_process_batch(B_global)
rng = np.random.default_rng(proc_id)
x0s = np.broadcast_to(sc.x0, (B_local, 8)).astype(np.float32).copy()
x0s[:, 2] += 0.05 * rng.standard_normal(B_local)

states = jax.vmap(
    lambda i: solver.init_state(jnp.asarray(x0s)[i], dtype=jnp.float32)
)(jnp.arange(B_local))
params = np.broadcast_to(sc.params, (B_local, 16)).astype(np.float32)
lhs = np.broadcast_to(sc.lh, (B_local, 8)).astype(np.float32)

states, x0g, pg, lhg = distributed.shard_batch_global(
    mesh, (states, x0s, params, lhs))
assert x0g.shape == (B_global, 8)

step = make_sharded_batch_solver(solver, mesh, donate=False)
states, outs = step(states, x0g, pg, lhg)
jax.block_until_ready(states)

frac, gmax = fleet_metrics(mesh, outs.status, outs.qp_gap)
frac, gmax = float(frac), float(gmax)
assert np.isfinite(gmax), gmax
assert 0.0 <= frac <= 1.0
print(f"proc {proc_id}: MULTIHOST OK frac={frac:.3f} gmax={gmax:.2e}",
      flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_mesh():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.update({
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
    })
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), "2", coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "MULTIHOST OK" in out, out
    # both processes saw the SAME globally reduced metrics
    vals = [out.rsplit("MULTIHOST OK", 1)[1].strip() for out in outs]
    assert vals[0] == vals[1], vals
