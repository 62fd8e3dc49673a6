"""Multi-device scaling bench: solves/s at 1/2/4/8 devices.

BASELINE.md names "solves/s efficiency at 1 chip / 1 host / N>=2 hosts" as a
target; the reference has no distributed story at all (one CPU solve per
tick, SURVEY.md section 2.3).  This bench measures WEAK scaling of the
production lane engine at the flagship configuration (nx=8, N=100, 10 IPM
iterations): per-device lane count is held fixed while the mesh grows, so
ideal scaling is solves/s proportional to device count and
efficiency(d) = solves_per_s(d) / (d * solves_per_s(1)).

With two or more GPUs the sweep runs on the cards (the Riccati sweep is
the plain `lax` one: the Triton kernel is not partitioned over a mesh
yet).  A CPU-only host rehearses the sharded program on a virtual CPU mesh
(the program is identical; only the transport differs, and the times are
CPU times, labelled with the platform):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benchmarks/bench_scaling.py
  Prints one
JSON line per mesh size plus a summary line with parallel efficiencies.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def measure(devices, n_devices, per_dev, ticks, ipm_iters, riccati):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.parallel import make_mesh
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes

    mesh = make_mesh(n_devices=n_devices, devices=devices)
    lane = LaneRTISolver(builders.usv_guidance_ca1(), ipm_iters=ipm_iters,
                         riccati=riccati)
    sc = scenarios.guidance_ca1_default()
    L = per_dev * n_devices
    rng = np.random.default_rng(0)
    x0b = np.broadcast_to(sc.x0, (L, 8)).astype(np.float32).copy()
    x0b[:, 2] += 0.1 * rng.standard_normal(L)

    def lane_shard(x):
        spec = P(*([None] * (x.ndim - 1) + ["dp"]))
        return jax.device_put(x, NamedSharding(mesh, spec))

    state = jax.tree.map(lane_shard, lane.init_state(x0b))
    xL = lane_shard(to_lanes(jnp.asarray(x0b)))
    pL = lane_shard(to_lanes(np.broadcast_to(
        sc.params, (L, 16)).astype(np.float32)))
    lhL = lane_shard(to_lanes(np.broadcast_to(
        sc.lh, (L, 8)).astype(np.float32)))

    step = jax.jit(lane.step_fn, donate_argnums=(0,))
    for _ in range(3):                       # compile + warm start
        state, outs = step(state, xL, pL, lhL)
        xL = outs.x1
    float(outs.gap.sum())                    # sync

    t0 = time.perf_counter()
    for _ in range(ticks):
        state, outs = step(state, xL, pL, lhL)
        xL = outs.x1
    float(outs.gap.sum())
    dt = time.perf_counter() - t0

    frac = float(np.mean(np.asarray(outs.status) == 0))
    assert frac > 0.9, f"unhealthy fleet at d={n_devices}: frac={frac}"
    return L * ticks / dt


def main():
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    from mpc_collisionavoidance_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    platform = os.environ.get("SCALE_PLATFORM", "")
    if not platform:
        # default: real accelerators when a multi-chip slice exists,
        # otherwise the virtual CPU mesh (scaling needs >= 2 devices)
        platform = (jax.default_backend()
                    if len(jax.devices()) >= 2 else "cpu")
    devices = jax.devices(platform)
    if platform == "cpu":
        jax.config.update("jax_default_device", devices[0])
    n_avail = len(devices)
    per_dev = int(os.environ.get("SCALE_LANES_PER_DEV", "256"))
    ticks = int(os.environ.get("SCALE_TICKS", "10"))
    ipm_iters = int(os.environ.get("BENCH_IPM_ITERS", "10"))
    riccati = os.environ.get("BENCH_RICCATI", "lax")

    sizes = [d for d in (1, 2, 4, 8) if d <= n_avail]
    results = {}
    for d in sizes:
        sps = measure(devices, d, per_dev, ticks, ipm_iters, riccati)
        results[d] = sps
        print(json.dumps({
            "metric": "nmpc_solves_per_s", "devices": d,
            "lanes": per_dev * d, "value": round(sps, 1),
            "unit": "solves/s", "backend": riccati, "platform": platform,
        }))

    base = results[sizes[0]]
    eff = {d: results[d] / (d * base) for d in sizes}
    summary = {
        "metric": "parallel_efficiency",
        "devices": sizes,
        "efficiency": {str(d): round(e, 3) for d, e in eff.items()},
        "backend": riccati,
        "platform": platform,
    }
    if platform == "cpu":
        # virtual CPU devices SHARE the host's physical cores: the weak-
        # scaling efficiency ceiling is physical_cores / devices, so these
        # numbers validate the sharded program + measure host saturation,
        # not chip-interconnect scaling (the solve itself has no
        # cross-instance collectives — on a real slice it is
        # embarrassingly parallel along the lane axis).
        summary["physical_cores"] = os.cpu_count()
        summary["note"] = ("virtual devices share physical cores; "
                           "efficiency ceiling = cores/devices")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
