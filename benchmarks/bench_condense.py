"""Partial-condensing sweep on the GPU: solves/s vs group size M.

Measures the flagship RTI tick (usv_guidance_ca1, N=100, B=512, 10 IPM
iterations) for condense group sizes M in {1, 2, 4, 5, 10, 20} with the
lax and pallas (Triton kernel) Riccati sweeps.  Partial condensing (HPIPM's knob,
ops/condense_partial.py) shrinks the sequential Riccati chain from 2N to
2N/M dependent steps — bound #2 of docs/PERF.md — at the cost of denser
(nu' = M*nu) per-stage blocks and a per-tick condense/expand pass.

Usage: python benchmarks/bench_condense.py [--ocp usv_pf_ca] [-B 512]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def bench_one(spec, sc, perturb_idx, B, M, riccati, iters, ticks=30):
    import jax
    import jax.numpy as jnp

    from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes

    m = spec.model
    solver = LaneRTISolver(spec, ipm_iters=iters, riccati=riccati,
                           condense=M)
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, perturb_idx] += 0.1 * rng.standard_normal(B)
    states = solver.init_state(x0s)
    xL = to_lanes(jnp.asarray(x0s, jnp.float32))
    pL = to_lanes(np.broadcast_to(sc.params, (B, m.np_)).astype(np.float32))
    lhL = to_lanes(np.broadcast_to(sc.lh, (B, m.nh)).astype(np.float32))
    step = jax.jit(solver.step_fn, donate_argnums=(0,))
    for _ in range(3):
        states, outs = step(states, xL, pL, lhL)
        xL = outs.x1
    float(outs.gap.sum())
    t0 = time.perf_counter()
    for _ in range(ticks):
        states, outs = step(states, xL, pL, lhL)
        xL = outs.x1
    float(outs.gap.sum())
    dt = time.perf_counter() - t0
    gaps = np.asarray(outs.gap)
    return B * ticks / dt, float(np.mean(gaps < 1e-5)), float(gaps.max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ocp", default="usv_guidance_ca1")
    ap.add_argument("-B", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--riccati", default="lax,pallas")
    ap.add_argument("--condense", default="1,2,4,5,10,20")
    args = ap.parse_args()

    from mpc_collisionavoidance_tpu.utils.device import (
        enable_compile_cache, require_gpu)

    enable_compile_cache()
    require_gpu()

    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import scenarios

    if args.ocp == "usv_pf_ca":
        spec, sc, perturb_idx = builders.usv_pf_ca(), scenarios.pf_ca_default(), 6
    else:
        spec, sc, perturb_idx = (builders.usv_guidance_ca1(),
                                 scenarios.guidance_ca1_default(), 2)

    for ric in args.riccati.split(","):
        for M in [int(x) for x in args.condense.split(",")]:
            try:
                sps, frac, gmax = bench_one(
                    spec, sc, perturb_idx, args.B, M, ric, args.iters,
                    args.ticks)
                print(f"riccati={ric:7s} M={M:3d}: {sps:9.1f} solves/s  "
                      f"converged={frac:.2f} max_gap={gmax:.1e}", flush=True)
            except Exception as e:
                print(f"riccati={ric:7s} M={M:3d}: FAILED "
                      f"{type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
