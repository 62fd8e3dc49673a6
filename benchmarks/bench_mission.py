"""Mission-length IPM schedule probe.

The reference's closed-loop harness runs 1000 sequential solves
(reference scripts/usv_guidance_ca1/main.py:116); the bench's historical
health gate only sampled a 30-tick window.  Round-4 judging measured that
the production adaptive@8 schedule fails its own 1e-5 duality-gap gate on
~41% of (tick, lane) solves once the obstacle constraints activate and
harden the QPs (ticks ~100-700).  This probe quantifies schedules at the
full mission length so the fix (per-lane stall escalation,
ops/ipm_lanes.py `extra_iters`) is chosen on data:

    python benchmarks/bench_mission.py --centering adaptive --iters 8
    python benchmarks/bench_mission.py --centering adaptive --iters 8 --extra 8
    python benchmarks/bench_mission.py --centering adaptive --iters 12

Reports converged_frac (gap < 1e-5 over ALL tick x lane solves — the
same gate bench.py applies), status-0 fraction, the worst gap and when it
happens, and wall-clock per tick.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--extra", type=int, default=0)
    ap.add_argument("--centering", default="adaptive")
    ap.add_argument("--riccati", default="lax")
    ap.add_argument("--ocp", default="usv_guidance_ca1")
    ap.add_argument("--gate", type=float, default=1e-5)
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions of the full mission scan")
    ap.add_argument("--platform", default=None,
                    help="pin jax platform (cpu/gpu) via "
                         "jax_default_device; the output names the "
                         "platform the probe ran on")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mpc_collisionavoidance_tpu.utils.device import enable_compile_cache

    if args.platform:
        jax.config.update("jax_default_device",
                          jax.devices(args.platform)[0])
    enable_compile_cache()

    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes

    if args.ocp == "usv_pf_ca":
        spec = builders.usv_pf_ca()
        sc = scenarios.pf_ca_default()
        perturb_idx = 6
    else:
        spec = builders.usv_guidance_ca1()
        sc = scenarios.guidance_ca1_default()
        perturb_idx = 2
    m = spec.model
    solver = LaneRTISolver(spec, ipm_iters=args.iters, riccati=args.riccati,
                           centering=args.centering,
                           extra_iters=args.extra)

    B = args.batch
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, perturb_idx] += 0.1 * rng.standard_normal(B)
    states = solver.init_state(x0s)
    xL = to_lanes(jnp.asarray(x0s, jnp.float32))
    pL = to_lanes(np.broadcast_to(sc.params, (B, m.np_)).astype(np.float32))
    lhL = to_lanes(np.broadcast_to(sc.lh, (B, m.nh)).astype(np.float32))

    def tick(c, _):
        st, x = c
        st, o = solver.step_fn(st, x, pL, lhL)
        return (st, o.x1), (o.gap, o.status)

    @jax.jit
    def mission(st, x):
        (st, x), (gaps, status) = jax.lax.scan(tick, (st, x), None,
                                               length=args.ticks)
        return gaps, status

    gaps, status = mission(states, xL)
    gaps = np.asarray(gaps)            # (ticks, L)
    status = np.asarray(status)

    t0 = time.perf_counter()
    for _ in range(args.reps):
        g2, _ = mission(states, xL)
    float(np.asarray(g2).sum())
    dt = (time.perf_counter() - t0) / args.reps

    conv = gaps < args.gate
    worst = int(np.argmax(gaps.max(axis=1)))
    line = {
        "ocp": args.ocp,
        "schedule": f"{args.centering}@{args.iters}"
                    + (f"+esc{args.extra}" if args.extra else ""),
        "riccati": args.riccati,
        "ticks": args.ticks,
        "batch": B,
        "mission_converged_frac": round(float(conv.mean()), 4),
        "status0_frac": round(float((status == 0).mean()), 4),
        "worst_gap": float(gaps.max()),
        "worst_gap_tick": worst,
        "tail_converged_frac": round(
            float(conv[args.ticks // 10:].mean()), 4),
        "ms_per_tick": round(dt * 1e3 / args.ticks, 3),
        "solves_per_s": round(B * args.ticks / dt, 1),
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
