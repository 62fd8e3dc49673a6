"""Tick anatomy: where the flagship lane-engine RTI tick goes on the GPU.

Times, scan-amortized on the card at the bench configuration (B=512, the
production preset; BENCH_RICCATI overrides its Riccati sweep):
  - the full step_fn tick,
  - QP build only (linearization + assembly; all fields reduced so
    nothing is dead-code-eliminated),
  - IPM only (per-iteration perturbed dx0 so the scan cannot hoist it),
  - one bare Riccati sweep (per-iteration perturbed gradient).

With BA_TRACE=<dir> it also records a profiler trace of three full ticks
and reports the device time inside the `linearize` named scope
(solver/batch.py) as a share of all device time in the window.

    python benchmarks/bench_anatomy.py
    BA_TRACE=chiprun_out/anatomy_trace python benchmarks/bench_anatomy.py
"""

import glob
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def device_time_by_scope(trace_dir, scope):
    """(ns inside `scope`, ns of all device ops) summed over the GPU
    planes of the newest trace under `trace_dir`.  An op counts as inside
    the scope when any of its event stats names it (XLA keeps named
    scopes in the op metadata)."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    data = jax.profiler.ProfileData.from_file(paths[-1])
    inside = total = 0
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                total += ev.duration_ns
                text = ev.name + " " + " ".join(
                    str(v) for _, v in ev.stats)
                if scope in text:
                    inside += ev.duration_ns
    return inside, total


def main():
    from mpc_collisionavoidance_tpu.utils.device import (
        enable_compile_cache, gpu_name_and_power, require_gpu)

    enable_compile_cache()
    dev = require_gpu()

    import jax
    import jax.numpy as jnp

    from mpc_collisionavoidance_tpu.config import production_engine
    from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
        KERNEL_MAX_NX, lqr_solve_lanes_pallas)
    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.ops.riccati_lanes import (
        lqr_solve_lanes, random_lane_lqr)
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.batch import (
        LaneRTISolver, to_lanes)

    B = int(os.environ.get("BA_BATCH", "512"))
    reps = int(os.environ.get("BA_REPS", "20"))
    preset = production_engine()
    riccati = os.environ.get("BENCH_RICCATI", preset.riccati)
    spec = builders.usv_guidance_ca1()
    m = spec.model
    sc = scenarios.guidance_ca1_default()
    solver = LaneRTISolver(spec, ipm_iters=preset.ipm_iters,
                           ipm_tol=preset.ipm_tol, riccati=riccati,
                           centering=preset.centering, mu0=preset.mu0,
                           extra_iters=preset.extra_iters,
                           stall_tol=preset.stall_tol)
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, 2] += 0.1 * rng.standard_normal(B)
    state = solver.init_state(x0s)
    xL = to_lanes(jnp.asarray(x0s, jnp.float32))
    pL = to_lanes(np.broadcast_to(sc.params, (B, m.np_)).astype(np.float32))
    lhL = to_lanes(np.broadcast_to(sc.lh, (B, m.nh)).astype(np.float32))
    out = {"riccati": riccati, "B": B, "device_kind": dev.device_kind}

    def timed(tag, fn, *args):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn(*args)
        jax.block_until_ready(res)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        out[tag] = ms
        print(f"{tag:28s} {ms:9.4f} ms", flush=True)
        return ms

    # warm the solver state closed-loop style
    step = jax.jit(solver.step_fn)
    for _ in range(3):
        state, o = step(state, xL, pL, lhL)
        xL = o.x1
    jax.block_until_ready(state)

    @jax.jit
    def full_scan(state, x):
        def tick(c, _):
            st, xx = c
            st, o = solver.step_fn(st, xx, pL, lhL)
            return (st, o.x1), o.gap
        (st, xx), gaps = jax.lax.scan(tick, (state, x), None, length=10)
        return gaps.sum()

    timed("full_tick_x10_ms", full_scan, state, xL)

    @jax.jit
    def build_scan(state, x):
        def tick(c, _):
            xx = c
            qp = solver._build_qp(state, xx, pL, lhL)
            s = sum(jnp.sum(getattr(qp, f)) for f in
                    ("A", "B", "c", "dx0", "qx", "qu", "ub_lo", "ub_hi",
                     "xb_lo", "xb_hi", "Ch", "hh_lo", "hh_hi", "Cs",
                     "hofs", "slh", "suh"))
            return xx + 1e-6 * s, s
        xx, ss = jax.lax.scan(tick, x, None, length=10)
        return ss.sum()

    timed("build_qp_x10_ms", build_scan, state, xL)

    qp0 = jax.jit(solver._build_qp)(state, xL, pL, lhL)

    @jax.jit
    def ipm_scan(qp, x):
        def it(c, _):
            qpx = qp._replace(dx0=qp.dx0 + 1e-7 * c)
            sol = solver._solve_qp(qpx)
            return c + 1e-6 * sol.du[0, 0], sol.gap
        c, gaps = jax.lax.scan(it, x[0], None, length=10)
        return gaps.sum()

    timed("ipm_x10_ms", ipm_scan, qp0, xL)

    d = random_lane_lqr(spec.N, m.nx, m.nu, B, seed=1)
    kernel = riccati == "pallas" or (riccati == "auto"
                                     and m.nx <= KERNEL_MAX_NX)
    fn = lqr_solve_lanes_pallas if kernel else lqr_solve_lanes

    @jax.jit
    def ric_scan(d, x):
        def it(c, _):
            dd = d._replace(qx=d.qx + 1e-7 * c)
            dx, du = fn(dd)
            return c + 1e-6 * du[0, 0], dx[0, 0]
        c, o = jax.lax.scan(it, x[0], None, length=10)
        return o.sum()

    timed("riccati_sweep_x10_ms", ric_scan, d, xL)

    trace_dir = os.environ.get("BA_TRACE")
    if trace_dir:
        jax.block_until_ready(full_scan(state, xL))
        with jax.profiler.trace(trace_dir):
            for _ in range(3):
                res = full_scan(state, xL)
            jax.block_until_ready(res)
        inside, total = device_time_by_scope(trace_dir, "linearize")
        out["trace_linearize_ns"] = inside
        out["trace_device_ns"] = total
        # None when no device op carried the scope's name: the share is
        # then unknown, not zero (build_qp_x10_ms still bounds it)
        out["trace_linearize_share"] = inside / total if inside else None
    print(json.dumps(out))
    print(gpu_name_and_power())


if __name__ == "__main__":
    main()
