"""RTI preparation/feedback split: measurement-to-command latency.

acados SQP_RTI splits each tick into a preparation phase (linearize +
assemble, done BEFORE the new measurement exists) and a feedback phase
(solve the QP at the fresh x0), minimizing the latency between measurement
and command (SURVEY.md section 7 hard part 4).  This bench measures, on the
current default device, the on-device latency of:

  - the fused single-phase tick (step_fn),
  - the feedback phase alone (feedback_fn on a prepared QP),
  - the preparation phase alone (prepare_fn — hidden from the critical
    path by running it after the command is published).

Run:  python benchmarks/bench_rti_split.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def _timed(fn, sync, reps=50):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(out)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return float(np.median(ts) * 1e3), float(np.percentile(ts, 99) * 1e3)


def main():
    import jax
    import jax.numpy as jnp

    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver

    ipm_iters = int(os.environ.get("BENCH_IPM_ITERS", "8"))
    spec = builders.usv_guidance_ca1()
    solver = RTISolver(spec, ipm_iters=ipm_iters)
    sc = scenarios.guidance_ca1_default()
    x0 = jnp.asarray(sc.x0, jnp.float32)
    p = jnp.asarray(sc.params, jnp.float32)
    lh = jnp.asarray(sc.lh, jnp.float32)

    step = jax.jit(solver.step_fn)
    prepare = jax.jit(solver.prepare_fn)
    feedback = jax.jit(solver.feedback_fn)

    st = solver.init_state(x0)
    # warm start + compile all three executables
    for _ in range(3):
        st, out = step(st, x0, p, lh)
    qp = prepare(st, p, lh)
    _, outf = feedback(st, qp, x0)
    float(outf.u0.sum())
    # the platform the compute ACTUALLY ran on (jax_default_device may
    # differ from default_backend())
    platform = next(iter(outf.u0.devices())).platform

    med_full, p99_full = _timed(
        lambda: step(st, x0, p, lh),
        lambda o: float(o[1].u0.sum()))
    med_fb, p99_fb = _timed(
        lambda: feedback(st, qp, x0),
        lambda o: float(o[1].u0.sum()))
    med_prep, p99_prep = _timed(
        lambda: prepare(st, p, lh),
        lambda o: float(o.dx0.sum()))

    print(json.dumps({
        "metric": "rti_split_latency_ms",
        "full_tick": {"p50": round(med_full, 3), "p99": round(p99_full, 3)},
        "feedback": {"p50": round(med_fb, 3), "p99": round(p99_fb, 3)},
        "prepare": {"p50": round(med_prep, 3), "p99": round(p99_prep, 3)},
        "feedback_vs_full": round(med_fb / med_full, 3),
        "platform": platform,
        "ipm_iters": ipm_iters,
    }))


if __name__ == "__main__":
    main()
