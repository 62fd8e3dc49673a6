"""One Riccati sweep on the card: the Pallas (Triton) kernel vs the plain
`lax.scan` path that XLA compiles, at the shapes the lane engine runs.

    python benchmarks/bench_riccati.py            # flagship + hull, L=1/512

Each timing chains 10 sweeps in one `lax.scan` (each sweep's gradient is
perturbed by the previous result, so nothing is hoisted) and reports the
per-sweep wall time on the host clock after `block_until_ready`, beside
the compile time of that chain.  Prints one JSON line per (shape, path),
then the card's name and power limit.  Refuses to run without a GPU.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    from mpc_collisionavoidance_tpu.utils.device import (
        enable_compile_cache, gpu_name_and_power, require_gpu)

    enable_compile_cache()
    dev = require_gpu()

    import jax

    from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
        lqr_solve_lanes_pallas)
    from mpc_collisionavoidance_tpu.ops.riccati_lanes import (
        lqr_solve_lanes, random_lane_lqr)

    reps = int(os.environ.get("BR_REPS", "20"))

    def per_sweep_ms(fn, d):
        @jax.jit
        def chain(d):
            def it(carry, _):
                dd = d._replace(qx=d.qx + 1e-7 * carry)
                dx, du = fn(dd)
                return carry + 1e-6 * du[0, 0], dx[0, 0]
            _, o = jax.lax.scan(it, d.qx[0, 0] * 0, None, length=10)
            return o.sum()

        t0 = time.perf_counter()
        compiled = chain.lower(d).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(compiled(d))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = compiled(d)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) * 1e3 / (10 * reps), compile_s

    shapes = os.environ.get("BR_SHAPES", "hull,flagship").split(",")
    dims = {"flagship": (8, 1), "hull": (14, 2)}
    for name in shapes:
        nx, nu = dims[name]
        for L in (1, 512):
            d = random_lane_lqr(100, nx, nu, L, seed=1)
            for path, fn in (("lax", lqr_solve_lanes),
                             ("pallas", lqr_solve_lanes_pallas)):
                ms, compile_s = per_sweep_ms(fn, d)
                print(json.dumps({"shape": name, "N": 100, "nx": nx,
                                  "nu": nu, "L": L, "path": path,
                                  "sweep_ms": ms, "compile_s": compile_s,
                                  "device_kind": dev.device_kind}),
                      flush=True)
    print(gpu_name_and_power())


if __name__ == "__main__":
    main()
