"""Verify drive: flagship closed loop on the GPU, production engine.

The canonical end-to-end check (see .claude/skills/verify): batch of
perturbed flagship scenarios, 1000-tick solver-as-plant closed loop
(reference scripts/usv_guidance_ca1/main.py:116,169-174) through the FULL
production preset (lane engine, Triton Riccati kernel, adaptive centering
+ stall escalation).  Asserts all-finite states, final cross-track error small,
minimum obstacle clearance within the soft band, and the mission-length
convergence gate.

Run:  python benchmarks/drive_verify.py   (refuses to run without a GPU)
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    from mpc_collisionavoidance_tpu.utils.device import (
        enable_compile_cache, require_gpu)

    enable_compile_cache()
    require_gpu()

    import jax
    import jax.numpy as jnp

    from mpc_collisionavoidance_tpu.config import production_engine
    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.batch import to_lanes

    print("devices:", jax.devices())
    spec = builders.usv_guidance_ca1()
    sc = scenarios.guidance_ca1_default()
    m = spec.model
    preset = production_engine()
    solver = preset.build(spec)
    print("engine:", preset)

    B = 32
    rng = np.random.default_rng(7)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, 2] += 0.15 * rng.standard_normal(B)     # de-correlate ye
    st = solver.init_state(x0s)
    xL = to_lanes(jnp.asarray(x0s, jnp.float32))
    pL = to_lanes(np.broadcast_to(sc.params, (B, m.np_)).astype(np.float32))
    lhL = to_lanes(np.broadcast_to(sc.lh, (B, m.nh)).astype(np.float32))

    def tick(c, _):
        st, x = c
        st, o = solver.step_fn(st, x, pL, lhL)
        return (st, o.x1), (x, o.gap, o.status)

    @jax.jit
    def run(st, x):
        (st, x), (xs, gaps, status) = jax.lax.scan(
            tick, (st, x), None, length=1000)
        return xs, gaps, status

    xs, gaps, status = run(st, xL)
    xs = np.asarray(xs)          # (1000, nx, B)
    gaps = np.asarray(gaps)
    status = np.asarray(status)

    assert np.all(np.isfinite(xs)), "non-finite states"
    ye_final = np.abs(xs[-50:, 2, :])
    assert ye_final.max() < 0.5, f"final |ye| {ye_final.max():.3f}"
    # min obstacle clearance >= lh - 0.2 soft band (reference lsh=-0.2,
    # scripts/usv_guidance_ca1/acados_settings.py:154-178)
    pos = xs[:, 5:7, :]                       # (T, 2, B)
    obst = np.asarray(sc.params).reshape(-1, 2)   # (8, 2)
    lh = np.asarray(sc.lh)
    d = np.linalg.norm(pos[:, None, :, :] - obst[None, :, :, None], axis=2)
    clear = (d - lh[None, :, None]).min()
    assert clear > -0.2, f"clearance {clear:.3f} below the soft band"
    conv = float((gaps < 1e-5).mean())
    assert conv > 0.99, f"mission converged_frac {conv:.3f}"
    print(f"OK  B={B} ticks=1000  converged_frac={conv:.4f}  "
          f"worst_gap={gaps.max():.2e}  status0={float((status==0).mean()):.3f}  "
          f"final|ye|max={ye_final.max():.3f}  min_clearance={clear:+.3f}")


if __name__ == "__main__":
    main()
