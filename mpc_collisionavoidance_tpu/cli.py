"""Experiment runner CLI — the reference's `python main.py` experience.

The reference runs one closed-loop experiment per variant directory,
printing avg/max solve time and MSE/MAE tracking errors and popping
matplotlib windows (reference scripts/usv_guidance_ca1/main.py:189-205).
Here one command runs any variant at any horizon from a JSON config or
flags, prints the same metrics as structured JSON, and saves the
dashboard PNGs:

    python -m mpc_collisionavoidance_tpu run --model usv_guidance_ca1 \
        --steps 1000 --plots /tmp/flagship
    python -m mpc_collisionavoidance_tpu run --config exp.json
    python -m mpc_collisionavoidance_tpu bench       # headline solves/s
    python -m mpc_collisionavoidance_tpu models      # list the zoo
"""

import argparse
import json
import sys


def _cmd_models(_args):
    from mpc_collisionavoidance_tpu.models import registry
    for name in registry.names():
        m = registry.get(name)
        print(f"{name:22s} nx={m.nx:2d} nu={m.nu} nh={m.nh} np={m.np_}")
    return 0


def _cmd_run(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_collisionavoidance_tpu.config import (
        FrameworkConfig, production_engine)
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.sim.closed_loop import run_closed_loop
    from mpc_collisionavoidance_tpu.utils.profiling import SolveTimer

    if args.platform:
        jax.config.update("jax_default_device",
                          jax.devices(args.platform)[0])

    if args.config:
        with open(args.config) as f:
            cfg = FrameworkConfig.from_dict(json.load(f))
    else:
        # unset -N/--tf fall back to the variant's own reference defaults
        # (builders encode the SURVEY.md 2.4 (Tf, N) per variant)
        from mpc_collisionavoidance_tpu.ocp import builders as _b
        import inspect
        N, Tf = args.N, args.tf
        if args.model in _b.BUILDERS:   # unknown names fall through to
            sig = inspect.signature(_b.BUILDERS[args.model])  # config's error
            if N is None:
                N = sig.parameters["N"].default
            if Tf is None:
                Tf = sig.parameters["Tf"].default
        # no config file -> the single production preset (the same engine
        # bench.py and the RT server CLI default to; config.py)
        cfg = FrameworkConfig(model=args.model, N=N or 100, Tf=Tf or 5.0,
                              solver=production_engine(args.platform))

    spec = cfg.build_spec()
    if cfg.solver.engine == "lane":
        # production lane engine behind the instance-shaped facade; the
        # lane path is float32 (the serving dtype)
        from mpc_collisionavoidance_tpu.solver.batch import LaneSolverAdapter
        solver = LaneSolverAdapter(cfg.build_solver())
        run_dtype = jnp.float32
    else:
        solver = cfg.build_solver()
        run_dtype = jnp.float64

    # scenario: each variant's true reference experiment (the role of the
    # per-variant scripts/<v>/main.py); model defaults otherwise.
    # entries: (factory, (heading-err idx, cross-track idx))
    table = {
        "usv_guidance_ca1": (scenarios.guidance_ca1_default, (3, 2)),
        "usv_guidance_ca": (scenarios.guidance_ca_default, (3, 2)),
        "usv_pf_ca": (scenarios.pf_ca_default, (0, 6)),
        "usv_pf": (scenarios.pf_default, (0, 6)),
        "usv_acados": (scenarios.acados_speed_default, (0, 0)),
        "usv_low_level": (scenarios.low_level_default, (0, 3)),
        "usv_position_control": (scenarios.position_control_default,
                                 (0, 1)),
        "usv_guidance": (scenarios.guidance_default, (2, 7)),
        "usv_guidance2": (scenarios.guidance2_default, (2, 8)),
        "usv_guidance3": (scenarios.guidance3_default, (2, 8)),
        "usv_guidance4": (scenarios.guidance4_default, (3, 2)),
        "usv_guidance5": (scenarios.guidance5_default, (3, 2)),
    }
    yref = yref_e = None
    if cfg.model in table:
        factory, err_idx = table[cfg.model]
        sc = factory()
        x0 = sc.x0
        m = spec.model
        params = (np.asarray(sc.params) if np.size(sc.params)
                  else np.zeros((m.np_,)))
        lh = jnp.asarray(sc.lh) if np.size(sc.lh) else None
        if sc.yref is not None:
            if cfg.solver.engine == "lane":
                # the lane engine broadcasts ONE stage reference (ny,)
                yref = jnp.asarray(sc.yref, run_dtype)
            else:
                yref = jnp.tile(jnp.asarray(sc.yref, run_dtype),
                                (spec.N, 1))
            yref_e = jnp.asarray(sc.yref_e, run_dtype)
    else:
        m = spec.model
        x0 = m.x0
        params = (np.full((m.np_,), 100.0) if m.np_ else np.zeros((0,)))
        lh = None
        err_idx = (0, 1) if m.nx >= 2 else (0, 0)

    run = jax.jit(lambda x, p: run_closed_loop(
        solver, x, p, lh, n_steps=args.steps, err_idx=err_idx,
        yref=yref, yref_e=yref_e,
        transient=min(400, args.steps // 2),
        metric_norm=max(args.steps - min(400, args.steps // 2), 1),
        dtype=run_dtype))
    timer = SolveTimer(batch=args.steps)
    with timer.tick():   # compile + full run (one device program)
        res = run(jnp.asarray(x0), jnp.asarray(params))
        jax.block_until_ready(res.simX)
    with timer.tick():   # steady-state rerun
        res = run(jnp.asarray(x0), jnp.asarray(params))
        jax.block_until_ready(res.simX)

    simX = np.asarray(res.simX)
    status = np.asarray(res.status)
    sv = cfg.solver
    out = {
        "model": cfg.model, "N": cfg.N, "Tf": cfg.Tf, "steps": args.steps,
        "engine": sv.engine,
        "schedule": f"{sv.centering}@{sv.ipm_iters}"
                    + (f"+esc{sv.extra_iters}" if sv.extra_iters else ""),
        "psi_mae": float(res.psi_mae), "ye_mae": float(res.ye_mae),
        "psi_mse": float(res.psi_mse), "ye_mse": float(res.ye_mse),
        "status_ok_rate": float(np.mean(status == 0)),
        "finite": bool(np.all(np.isfinite(simX))),
        "compile_plus_run_s": round(timer.samples[0], 3),
        "steady_run_s": round(timer.samples[1], 3),
        "solves_per_s_closed_loop": round(args.steps / timer.samples[1], 1),
    }
    print(json.dumps(out))

    if args.plots:
        from mpc_collisionavoidance_tpu.utils import plotting
        if cfg.model == "usv_guidance_ca1":
            obstacles = np.asarray(params).reshape(-1, 2)[:4]
            radii = np.asarray(lh)[:4]
            plotting.plot_flagship(simX, np.asarray(res.simU), spec.dt,
                                   obstacles, radii, save_path=args.plots)
            print(f"plots: {args.plots}_timeseries.png, {args.plots}_xy.png",
                  file=sys.stderr)
        elif cfg.model in ("usv_pf", "usv_pf_ca"):
            if cfg.model == "usv_pf_ca":
                obstacles = np.asarray(params).reshape(-1, 2)
                radii = np.asarray(lh)
            else:
                obstacles = radii = None
            plotting.plot_pf_family(simX, np.asarray(res.simU), spec.dt,
                                    obstacles, radii, save_path=args.plots)
            print(f"plots: {args.plots}_{{timeseries,xy,errors}}.png",
                  file=sys.stderr)
    return 0 if out["finite"] else 1


def _cmd_race(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim.closed_loop import run_closed_loop
    from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver
    from mpc_collisionavoidance_tpu.utils import track as trk

    if args.platform:
        jax.config.update("jax_default_device",
                          jax.devices(args.platform)[0])
    t = trk.make_synthetic_track()
    spec = builders.build("race_cars", track=t)
    m = spec.model
    solver = RTISolver(spec, ipm_iters=18)
    ny, nx, N = spec.cost.ny, m.nx, spec.N

    def yref_fn(x, k):
        # the reference's receding progress reference: s ramps from the
        # current s0 to s0 + 3 across the horizon (race_cars/main.py:74-83)
        s0 = x[0]
        ramp = s0 + 3.0 * jnp.arange(N) / N
        return (jnp.zeros((N, ny)).at[:, 0].set(ramp),
                jnp.zeros(nx).at[0].set(s0 + 3.0))

    res = jax.jit(lambda x: run_closed_loop(
        solver, x, jnp.zeros(0), n_steps=args.steps,
        yref_fn=yref_fn))(jnp.asarray(m.x0, jnp.float64))
    simX = np.asarray(res.simX)
    status = np.asarray(res.status)
    out = {
        "track_length_m": round(t.length, 3),
        "steps": args.steps,
        "s_final": round(float(simX[-1, 0]), 3),
        "laps": round(float(simX[-1, 0]) / t.length, 2),
        "v_max": round(float(np.max(simX[:, 3])), 3),
        "n_abs_max": round(float(np.max(np.abs(simX[:, 1]))), 4),
        "status_ok_rate": float(np.mean(status == 0)),
        "finite": bool(np.all(np.isfinite(simX))),
    }
    print(json.dumps(out))
    if args.plots:
        from mpc_collisionavoidance_tpu.utils import plotting
        plotting.plot_race_track(t, simX, save_path=args.plots)
        print(f"plot: {args.plots}_track.png", file=sys.stderr)
    return 0 if out["finite"] else 1


def _cmd_bench(_args):
    import runpy
    sys.argv = ["bench.py"]
    from pathlib import Path
    bench = Path(__file__).resolve().parent.parent / "bench.py"
    runpy.run_path(str(bench), run_name="__main__")
    return 0



def _cmd_mission(args):
    """Full flagship mission (waypoints + fake LiDAR field) with the
    live-safety-marker outputs: JSONL stream and/or animated GIF — the
    reference's rviz obstacle/safety-band visualization
    (src/nmpc_guidance_ca1.cpp:378-414), on the device."""
    import jax

    from mpc_collisionavoidance_tpu.guidance import (
        GuidanceController, Measurements)
    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import mission, scenarios
    from mpc_collisionavoidance_tpu.utils import viz

    if args.platform:
        jax.config.update("jax_default_device",
                          jax.devices(args.platform)[0])

    import numpy as np

    # missions ride the same production engine as bench/server (the
    # lane engine behind the instance-shaped adapter; config.py)
    from mpc_collisionavoidance_tpu.config import production_engine
    from mpc_collisionavoidance_tpu.solver.batch import LaneSolverAdapter

    spec = builders.usv_guidance_ca1()
    preset = production_engine(args.platform)
    ctrl = GuidanceController(spec,
                              solver=LaneSolverAdapter(preset.build(spec)))
    if args.challenge == 1:
        # the AutonomousNavigation course through the 21-buoy field
        wps, n_wp, field, valid = scenarios.autonav_mission()
        meas0 = Measurements(u=0.7, v=0.0, nedx=0.0, nedy=0.0, psi=0.0)
    else:
        # challenge 0: the straight two-leg line through the 4 big buoys
        field, valid = scenarios.challenge0_field()
        wps = np.array([[4.0, -5.0], [4.0, 25.0]])
        n_wp = 2
        meas0 = Measurements(u=0.7, v=0.0, nedx=4.0, nedy=-5.0,
                             psi=np.pi / 2)
    log = jax.jit(lambda m: mission.run_mission(
        ctrl, m, wps, n_wp, field, valid, n_steps=args.steps))(meas0)

    frames = viz.frames_from_mission(log, field, valid,
                                     stride=args.stride)
    n_coll = sum(f.collision for f in frames)
    print(json.dumps({"ticks": args.steps, "frames": len(frames),
                      "collisions": int(n_coll),
                      "final_pos": [round(float(v), 3)
                                    for v in log.pos[-1]]}))
    if args.markers:
        viz.write_jsonl(frames, args.markers)
        print(f"marker stream -> {args.markers}")
    if args.gif:
        viz.render_animation(frames, args.gif, fps=args.fps)
        print(f"animation -> {args.gif}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mpc_collisionavoidance_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="closed-loop experiment")
    p_run.add_argument("--config", help="FrameworkConfig JSON file")
    p_run.add_argument("--model", default="usv_guidance_ca1")
    p_run.add_argument("-N", type=int, default=None,
                       help="horizon stages (default: the variant's "
                            "reference value)")
    p_run.add_argument("--tf", type=float, default=None,
                       help="horizon length [s] (default: the variant's "
                            "reference value)")
    p_run.add_argument("--steps", type=int, default=1000)
    p_run.add_argument("--plots", help="save dashboards to this path prefix")
    p_run.add_argument("--platform", help="pin jax platform (cpu/gpu)")
    p_run.set_defaults(fn=_cmd_run)

    p_race = sub.add_parser(
        "race", help="race the synthetic closed track (curved-kappa "
                     "race_cars with the receding progress reference)")
    p_race.add_argument("--steps", type=int, default=700)
    p_race.add_argument("--plots", help="save the track plot to this prefix")
    p_race.add_argument("--platform", help="pin jax platform (cpu/gpu)")
    p_race.set_defaults(fn=_cmd_race)

    p_mis = sub.add_parser(
        "mission", help="flagship mission with live safety markers "
                        "(JSONL stream / GIF) — the rviz-marker role")
    p_mis.add_argument("--steps", type=int, default=600)
    p_mis.add_argument("--challenge", type=int, default=0, choices=(0, 1))
    p_mis.add_argument("--stride", type=int, default=2,
                       help="render every k-th tick")
    p_mis.add_argument("--markers", help="write the JSONL marker stream here")
    p_mis.add_argument("--gif", help="render an animated GIF here")
    p_mis.add_argument("--fps", type=int, default=20)
    p_mis.add_argument("--platform", help="pin jax platform (cpu/gpu)")
    p_mis.set_defaults(fn=_cmd_mission)

    p_bench = sub.add_parser("bench", help="headline throughput benchmark")
    p_bench.set_defaults(fn=_cmd_bench)

    p_models = sub.add_parser("models", help="list the model zoo")
    p_models.set_defaults(fn=_cmd_models)

    args = parser.parse_args(argv)
    from mpc_collisionavoidance_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
