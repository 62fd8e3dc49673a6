"""Headline benchmark: batched flagship NMPC solves/s on one GPU.

Measures steady-state RTI solve throughput for the usv_guidance_ca1 OCP at
its real-time configuration (nx=8, nu=1, N=100, 8 soft obstacle constraints,
SURVEY.md section 6) using the lane-batched engine (solver/batch.py): the
scenario batch rides the minor-most lane axis, so every small-matrix op in
the Riccati/IPM stack is elementwise over the batch.

The reference executes 1 solve/tick on a boat CPU at 20 Hz; its offline
harness is 1 sequential solve per loop iteration (reference
scripts/usv_guidance_ca1/main.py:133-144).  `vs_baseline` divides by the
historical 5000 solves/s target.

Refuses to run without a GPU: a CPU timing is not a device number.  The
JSON line names the device (platform, kind, count, the card's name and
power limit from nvidia-smi) and XLA_FLAGS.

Engine defaults come from the SINGLE production preset
(config.production_engine()) — the same engine the RT server CLI and
`cli run/mission` default to — so the benched configuration IS the shipped
configuration.  BENCH_* env vars override individual fields.

Tiers in the one JSON line (every gate is checked; a failed gate is listed
under "gates_failed" and makes the exit code 1, after the line is printed):
- throughput:  B=512 closed-loop ticks chained in lax.scan (device
  throughput, how every production path runs) + dispatched_solves_per_s
  (one Python dispatch per tick) + a 30-tick converged_frac health gate.
  The chunk starts cold, so it carries the escalation sweeps the first
  few ticks genuinely cost; mission_solves_per_s is the whole-1000-tick
  figure including mid-mission QP hardening.
- latency:     B=1 / B=8 flagship on-device p50/p99 vs the 50 ms @ 20 Hz
  budget (reference src/nmpc_guidance_ca1.cpp:612).
- full hull:   usv_pf_ca (nx=14) B=1 on-device p99 vs the 10 ms @ 100 Hz
  budget (reference src/nmpc_pf.cpp:388).
- mission:     the reference's full 1000-tick closed loop (reference
  scripts/usv_guidance_ca1/main.py:116) at the production schedule;
  mission_converged_frac must stay > 0.9 under the same 1e-5 gap gate —
  the 30-tick window alone hides mid-mission QP hardening (docs/PERF.md).
- serving:     request->reply through a live rt/server.py over a UDS
  loopback (the reference's node boundary, src/nmpc_guidance_ca1.cpp:612),
  B=1 and an 8-vehicle fleet, decomposed into serving-stack overhead vs
  device dispatch+solve via server-side timing.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import sys
import time

import numpy as np


def _p(xs, q):
    return float(np.percentile(np.asarray(xs, float), q))


def _progress(tier, line):
    """The line so far, on stderr: a run cut short still shows its tiers."""
    print(f"bench: {tier} tier done: {json.dumps(line)}", file=sys.stderr,
          flush=True)


def engine_defaults(preset=None):
    """The benched engine config: the SINGLE production preset
    (config.production_engine() — the same engine the RT server CLI and
    `cli run/mission` default to), with BENCH_* env overrides on top.
    tests/test_production_preset.py asserts the three surfaces agree."""
    if preset is None:
        from mpc_collisionavoidance_tpu.config import production_engine
        preset = production_engine()
    # the production schedule: adaptive per-lane centering reaches the
    # float32 duality-gap floor by 8 iterations on the easy regime, and
    # the stall-escalation budget buys extra iterations ONLY on ticks
    # where some lane is still above tolerance (mid-mission QP hardening;
    # docs/PERF.md "Mission-length convergence")
    return {
        "ipm_iters": int(os.environ.get("BENCH_IPM_ITERS",
                                        preset.ipm_iters)),
        # the production tolerance (status-0 gate AND escalation target)
        "ipm_tol": float(os.environ.get("BENCH_IPM_TOL", preset.ipm_tol)),
        "centering": os.environ.get("BENCH_CENTERING", preset.centering),
        "riccati": os.environ.get("BENCH_RICCATI", preset.riccati),
        "extra_iters": int(os.environ.get("BENCH_EXTRA_ITERS",
                                          preset.extra_iters)),
        # escalation gate: iterate stalled batches only while some lane's
        # gap is above THIS (preset 3e-6: 3x margin under the 1e-5 health
        # gate without chasing the 5e-7 f32 floor on easy ticks)
        "stall_tol": float(os.environ["BENCH_STALL_TOL"]) \
            if "BENCH_STALL_TOL" in os.environ else preset.stall_tol,
        # initial barrier weight (float or "auto")
        "mu0": (os.environ["BENCH_MU0"] if os.environ.get("BENCH_MU0")
                == "auto" else float(os.environ["BENCH_MU0"]))
        if "BENCH_MU0" in os.environ else preset.mu0,
        # partial-condensing group size (HPIPM's knob): 1 = full-resolution
        # QP
        "condense": int(os.environ.get("BENCH_CONDENSE", "1")),
    }


def device_line() -> dict:
    """Device identity for the JSON line; raises without a GPU."""
    import jax

    from mpc_collisionavoidance_tpu.utils.device import (
        device_fields, gpu_name_and_power, require_gpu)

    require_gpu()
    dev = device_fields()
    card = gpu_name_and_power().splitlines()[0]
    name, _, power = card.rpartition(",")
    return {"platform": dev["platform"], "device_kind": dev["kind"],
            "device_count": dev["count"], "card": name.strip(),
            "power_limit": power.strip(), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def main():
    from mpc_collisionavoidance_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    device = device_line()

    import jax
    import jax.numpy as jnp

    from mpc_collisionavoidance_tpu.ocp import builders
    from mpc_collisionavoidance_tpu.sim import scenarios
    from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver, to_lanes

    # the headline batch; the GPU's best batch size is open (docs/PERF.md)
    B = int(os.environ.get("BENCH_BATCH", "512"))
    ticks = int(os.environ.get("BENCH_TICKS", "30"))
    eng = engine_defaults()

    # BENCH_OCP selects the benched OCP: the flagship (default) or the
    # full 14-state hydrodynamic hull (usv_pf_ca: nu=2, HARD h rows)
    ocp = os.environ.get("BENCH_OCP", "usv_guidance_ca1")
    if ocp == "usv_pf_ca":
        spec = builders.usv_pf_ca()              # Tf=1, N=100, nx=14
        sc = scenarios.pf_ca_default()
        perturb_idx = 6                          # ye
    else:
        spec = builders.usv_guidance_ca1()       # Tf=5, N=100, nx=8
        sc = scenarios.guidance_ca1_default()
        perturb_idx = 2                          # ye
    m = spec.model
    solver = LaneRTISolver(spec, **eng)

    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, perturb_idx] += 0.1 * rng.standard_normal(B)  # de-correlate
    states = solver.init_state(x0s)
    xL = to_lanes(jnp.asarray(x0s, jnp.float32))
    pL = to_lanes(np.broadcast_to(sc.params, (B, m.np_)).astype(np.float32))
    lhL = to_lanes(np.broadcast_to(sc.lh, (B, m.nh)).astype(np.float32))

    # the throughput WORKLOAD is the canonical `ticks`-tick warm-started
    # closed loop from the scenario start (x0 <- stage-1 feedback, the
    # reference's solver-as-plant idiom), chained in ONE lax.scan
    # executable — how every production path runs it (scanned sims,
    # missions, the RT server's single fleet tick).  It is executed
    # `reps` times from the same device-resident initial state; the
    # repeat dispatches are independent, so dispatch overhead pipelines
    # away instead of being billed to the solver.  The same workload
    # driven one dispatch per tick is reported as
    # dispatched_solves_per_s for transparency.
    reps = int(os.environ.get("BENCH_REPS", "8"))

    def make_chunk(sv):
        def tick(c, _):
            st, x = c
            st, o = sv.step_fn(st, x, pL, lhL)
            return (st, o.x1), o.gap

        @jax.jit
        def run_chunk(states, x):
            (st, xx), gaps = jax.lax.scan(tick, (states, x), None,
                                          length=ticks)
            return gaps[-1]

        return run_chunk

    run_chunk = make_chunk(solver)
    states0, xL0 = states, xL

    # a kernel that fails to compile or run fails the bench: there is no
    # fallback to another Riccati path
    gaps = run_chunk(states0, xL0)
    # an explicit scalar fetch is the sync point
    float(gaps.sum())

    t0 = time.perf_counter()
    for _ in range(reps):
        gaps = run_chunk(states0, xL0)
    float(gaps.sum())
    dt = time.perf_counter() - t0
    solves_per_s = B * reps * ticks / dt

    # legacy per-dispatch path (one Python->device round trip per tick),
    # same feedback loop driven from Python
    step = jax.jit(solver.step_fn)
    states, xL = states0, xL0
    states, outs = step(states, xL, pL, lhL)
    xL = outs.x1
    float(outs.gap.sum())
    t0 = time.perf_counter()
    for _ in range(max(ticks // 2, 5)):
        states, outs = step(states, xL, pL, lhL)
        xL = outs.x1
    float(outs.gap.sum())
    dispatched = B * max(ticks // 2, 5) / (time.perf_counter() - t0)

    # health gate: the throughput number only counts if the solves are
    # actually converging (guards against a fast-but-garbage regression)
    gaps = np.asarray(gaps)
    converged_frac = float(np.mean(gaps < 1e-5))
    failed = []
    if not np.all(np.isfinite(gaps)):
        failed.append("throughput: non-finite duality gaps")
    if not converged_frac > 0.9:
        failed.append(f"throughput: converged_frac {converged_frac} <= 0.9")
    baseline = 5000.0
    line = {
        "metric": "nmpc_solves_per_s_per_chip",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / baseline,
        **device,
        "backend": eng["riccati"],
        "centering": eng["centering"],
        "ipm_iters": eng["ipm_iters"],
        "extra_iters": eng["extra_iters"],
        "converged_frac": converged_frac,
        # same workload, one Python->device dispatch per tick: what a
        # host-driven loop sees (the gap to the headline is the per-tick
        # dispatch and sync)
        "dispatched_solves_per_s": dispatched,
    }
    if ocp != "usv_guidance_ca1":
        line["ocp"] = ocp
    if eng["condense"] != 1:
        line["condense"] = eng["condense"]
    _progress("throughput", line)

    # ---- mission-length convergence tier -----------------------------
    # The reference's closed-loop harness is 1000 sequential solves
    # (scripts/usv_guidance_ca1/main.py:116); mid-mission the obstacle
    # rows activate and harden the QPs, which a 30-tick window never
    # sees (round-4 VERDICT).  The production schedule must hold the
    # SAME 1e-5 gate over the whole mission.
    if os.environ.get("BENCH_MISSION", "1") != "0":
        mticks = int(os.environ.get("BENCH_MISSION_TICKS", "1000"))

        def mtick(c, _):
            st, x = c
            st, o = solver.step_fn(st, x, pL, lhL)
            return (st, o.x1), (jnp.mean((o.gap < 1e-5).astype(jnp.float32)),
                                jnp.max(o.gap))

        @jax.jit
        def run_mission(states, x):
            _, (fr, gmax) = jax.lax.scan(mtick, (states, x), None,
                                         length=mticks)
            return fr, gmax

        # COLD start: the mission tier is the whole reference run from
        # the scenario start, cold-start ticks and mid-mission QP
        # hardening included
        st_m = solver.init_state(x0s)
        x_m = to_lanes(jnp.asarray(x0s, jnp.float32))
        fr, gmax = run_mission(st_m, x_m)
        fr = np.asarray(fr)
        gmax = np.asarray(gmax)
        t0 = time.perf_counter()
        fr2, _ = run_mission(st_m, x_m)
        float(np.asarray(fr2).sum())
        mdt = time.perf_counter() - t0
        line["mission_ticks"] = mticks
        line["mission_converged_frac"] = float(fr.mean())
        line["mission_worst_gap"] = float(gmax.max())
        line["mission_worst_gap_tick"] = int(np.argmax(gmax))
        line["mission_solves_per_s"] = B * mticks / mdt
        if not np.all(np.isfinite(gmax)):
            failed.append("mission: non-finite gaps")
        if not line["mission_converged_frac"] > 0.9:
            failed.append(
                "mission: converged_frac "
                f"{line['mission_converged_frac']} <= 0.9 (worst gap "
                f"{line['mission_worst_gap']:.2e} at tick "
                f"{line['mission_worst_gap_tick']})")
        _progress("mission", line)

    # ---- single-vehicle latency tiers (the boat use-case: ONE vehicle
    # at 20 Hz / 100 Hz).  B=1 rides the SAME lane engine and Riccati
    # kernel (the kernel pads the lane to one lane group).  Two
    # measurements per batch size:
    #   *_ondevice_ms — K RTI ticks chained in ONE lax.scan dispatch,
    #     per-tick = call/K; amortizes the host dispatch to 1/K.
    #     p50/p99 over reps.
    #   *_client_ms — one dispatch + sync per tick: what a host-driven
    #     controller loop observes.
    scan_len = int(os.environ.get("BENCH_LAT_SCAN", "25"))
    lat_reps = int(os.environ.get("BENCH_LAT_REPS", "40"))

    def latency_tier(lspec, lsc, lperturb, Bl):
        lm = lspec.model
        sol = LaneRTISolver(lspec, **eng)
        lx0 = np.broadcast_to(lsc.x0, (Bl, lm.nx)).copy()
        lx0[:, lperturb] += 0.1 * rng.standard_normal(Bl)
        st = sol.init_state(lx0)
        xl = to_lanes(jnp.asarray(lx0, jnp.float32))
        pl = to_lanes(np.broadcast_to(
            lsc.params, (Bl, lm.np_)).astype(np.float32))
        lhl = to_lanes(np.broadcast_to(
            lsc.lh, (Bl, lm.nh)).astype(np.float32))

        def chain(carry, _):
            s, x = carry
            s, o = sol.step_fn(s, x, pl, lhl)
            return (s, o.x1), o.gap

        @jax.jit
        def run_scan(s, x):
            (s, x), gaps = jax.lax.scan(chain, (s, x), None,
                                        length=scan_len)
            return s, x, gaps

        step = jax.jit(sol.step_fn)
        # warmup compiles both executables
        st, out = step(st, xl, pl, lhl)
        xl = out.x1
        st, xl, gaps = run_scan(st, xl)
        float(gaps.sum())

        per_tick = []
        for _ in range(lat_reps):
            t0 = time.perf_counter()
            st, xl, gaps = run_scan(st, xl)
            float(gaps.sum())
            per_tick.append(
                (time.perf_counter() - t0) * 1e3 / scan_len)
        client = []
        for _ in range(lat_reps):
            t0 = time.perf_counter()
            st, out = step(st, xl, pl, lhl)
            xl = out.x1
            float(out.gap.sum())
            client.append((time.perf_counter() - t0) * 1e3)
        if not np.all(np.asarray(gaps)[-1] < 1e-4):
            failed.append(f"latency B={Bl}: final gaps not converged")
        return (_p(per_tick, 50), _p(per_tick, 99),
                _p(client, 50), _p(client, 99))

    if os.environ.get("BENCH_LATENCY", "1") != "0":
        for Bl, tag in ((1, "b1"), (8, "b8")):
            p50, p99, c50, c99 = latency_tier(spec, sc, perturb_idx, Bl)
            line[f"{tag}_ondevice_p50_ms"] = p50
            line[f"{tag}_ondevice_p99_ms"] = p99
            line[f"{tag}_client_p50_ms"] = c50
            line[f"{tag}_client_p99_ms"] = c99
        # the real-time gate: one vehicle, on-device, p99 under the
        # 50 ms @ 20 Hz budget (BASELINE.md latency target)
        if not line["b1_ondevice_p99_ms"] < 50.0:
            failed.append(f"latency: B=1 p99 {line['b1_ondevice_p99_ms']} "
                          "ms >= 50 ms")
        _progress("latency", line)

    # ---- full-hull 100 Hz tier ----------------------------------------
    # The reference's pf/low-level nodes run at 100 Hz (<= 10 ms/solve,
    # src/nmpc_pf.cpp:388).  The 14-state hydrodynamic hull with HARD
    # obstacle rows is the heavier OCP; its B=1 on-device p99 must meet
    # the 100 Hz budget, not just the flagship's 20 Hz one.
    if (os.environ.get("BENCH_FULL_HULL", "1") != "0"
            and ocp != "usv_pf_ca"):
        pf_spec = builders.usv_pf_ca()
        pf_sc = scenarios.pf_ca_default()
        p50, p99, _, _ = latency_tier(pf_spec, pf_sc, 6, 1)
        line["pf_b1_ondevice_p50_ms"] = p50
        line["pf_b1_ondevice_p99_ms"] = p99
        if not p99 < 10.0:
            failed.append(f"full hull: B=1 p99 {p99} ms >= 10 ms "
                          "(100 Hz budget)")
        _progress("full hull", line)

    # ---- serving-path latency tier -----------------------------------
    # request->reply through a LIVE rt/server.py over a UDS loopback —
    # the reference's node boundary (one acados_solve per 20 Hz tick
    # behind ROS topics, src/nmpc_guidance_ca1.cpp:577,612).  Server-side
    # solve timing decomposes each tick into serving-stack overhead
    # (transport + batching + pack/unpack) vs device dispatch+solve.
    if os.environ.get("BENCH_SERVING", "1") != "0":
        rt, rt_failed = serving_tier(eng=eng)
        line.update(rt)
        failed += rt_failed

    line["gates_failed"] = failed
    print(json.dumps(line))
    if failed:
        sys.exit(1)


def serving_tier(eng: dict):
    """Drive a live RTServer over UDS: B=1 (200 ticks) and an 8-vehicle
    fleet (100 ticks), client-timed request->reply with server-side solve
    decomposition.  Returns the rt_* entries for the bench line and the
    list of failed serving gates."""
    import asyncio
    import socket
    import struct
    import tempfile
    import threading
    from pathlib import Path

    from mpc_collisionavoidance_tpu.rt import protocol
    from mpc_collisionavoidance_tpu.rt.server import RTServer
    from mpc_collisionavoidance_tpu.sim import scenarios

    sc = scenarios.guidance_ca1_default()
    sock_path = str(Path(tempfile.mkdtemp()) / "nmpc_bench.sock")
    server = RTServer(sock_path, engine="lane",
                      ipm_iters=eng["ipm_iters"], ipm_tol=eng["ipm_tol"],
                      riccati=eng["riccati"],
                      centering=eng["centering"],
                      extra_iters=eng["extra_iters"],
                      stall_tol=eng["stall_tol"], mu0=eng["mu0"],
                      max_batch=128, batch_window_ms=2.0)
    loop = asyncio.new_event_loop()

    def _run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        loop.run_forever()

    thread = threading.Thread(target=_run, daemon=True)
    server.warmup()
    thread.start()
    deadline = time.time() + 20
    while not Path(sock_path).exists():
        assert time.time() < deadline, "bench serving: socket never appeared"
        time.sleep(0.05)

    x0 = tuple(float(v) for v in np.asarray(sc.x0, np.float32))
    p_obs = tuple(float(v) for v in np.asarray(sc.params, np.float32))
    r_obs = tuple(float(v) for v in np.asarray(sc.lh, np.float32))

    def connect():
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(30.0)
        s.connect(sock_path)
        return s

    def tick(s, seq, x):
        s.sendall(protocol.pack_request(protocol.Request(
            seq=seq, x0=x, p_obs=p_obs, r_obs=r_obs)))
        buf = b""
        while len(buf) < protocol.RESP_SIZE:
            buf += s.recv(protocol.RESP_SIZE - len(buf))
        resp = protocol.unpack_response(buf)
        assert resp.seq == seq
        return resp

    out = {}
    warm = 5

    # --- B=1: one vehicle, sequential ticks (the boat) ---
    n1 = int(os.environ.get("BENCH_RT_TICKS", "200"))
    s1 = connect()
    totals, x = [], x0
    n_solve0 = len(server.solve_ms)
    for seq in range(n1):
        t0 = time.perf_counter()
        resp = tick(s1, seq, x)
        totals.append((time.perf_counter() - t0) * 1e3)
        x = resp.x1                       # solver-as-plant feedback
    s1.close()
    solves = list(server.solve_ms)[n_solve0:]
    # align request i <-> solve i (single client, sequential): overhead =
    # client-observed total minus the server's device dispatch+solve
    overhead = [t - sv for t, sv in zip(totals[warm:], solves[warm:])]
    out["rt_transport"] = "uds"
    out["rt_b1_p50_ms"] = _p(totals[warm:], 50)
    out["rt_b1_p99_ms"] = _p(totals[warm:], 99)
    out["rt_b1_solve_p50_ms"] = _p(solves[warm:], 50)
    out["rt_b1_overhead_p50_ms"] = _p(overhead, 50)
    out["rt_b1_overhead_p99_ms"] = _p(overhead, 99)

    # --- 8-vehicle fleet: 8 connections, lockstep ticks ---
    nf = int(os.environ.get("BENCH_RT_FLEET_TICKS", "100"))
    socks = [connect() for _ in range(8)]
    xs = [x0] * 8
    ftotals = []
    for seq in range(nf):
        t0 = time.perf_counter()
        for i, s in enumerate(socks):
            s.sendall(protocol.pack_request(protocol.Request(
                seq=seq, x0=xs[i], p_obs=p_obs, r_obs=r_obs)))
        for i, s in enumerate(socks):
            buf = b""
            while len(buf) < protocol.RESP_SIZE:
                buf += s.recv(protocol.RESP_SIZE - len(buf))
            xs[i] = protocol.unpack_response(buf).x1
        ftotals.append((time.perf_counter() - t0) * 1e3)
    for s in socks:
        s.close()
    out["rt_fleet8_p50_ms"] = _p(ftotals[warm:], 50)
    out["rt_fleet8_p99_ms"] = _p(ftotals[warm:], 99)

    async def _stop():
        await server.stop()
    asyncio.run_coroutine_threadsafe(_stop(), loop).result(5)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(5)

    # the deployment gates: the serving stack's own cost must be a small
    # fraction of the 50 ms @ 20 Hz budget, and the typical end-to-end
    # tick must fit the budget
    failed = [f"serving: {k} {out[k]} ms >= {lim} ms"
              for k, lim in (("rt_b1_overhead_p99_ms", 10.0),
                             ("rt_b1_p50_ms", 50.0),
                             ("rt_fleet8_p50_ms", 50.0))
              if not out[k] < lim]
    return out, failed


if __name__ == "__main__":
    main()
