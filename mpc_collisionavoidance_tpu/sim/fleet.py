"""Fleet mission engine: vmapped guidance logic + lane-batched solver.

`sim/mission.py` batches whole missions with `jax.vmap` of the
per-instance controller — correct, but the solve then runs in the vmapped
(batch-major) layout, which is ~7x slower than the lane engine
(ops/lanes.py).  Here the two layouts are mixed per tick:

- mission management, perception and plant stepping stay batch-first and
  are vmapped (they are elementwise in the vehicle axis — layout is
  irrelevant);
- the RTI solve runs in the lane engine with the vehicle axis minor-most;
- the only glue is a pair of O(nx*B) transposes per tick, negligible next
  to the solve.

The result is one compiled program per tick (scanned over the mission)
whose hot 95% runs at lane-engine throughput, with the full flagship node
behavior (waypoint manager, top-8 LiDAR intake, command memory) per
vehicle.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.guidance import obstacles as obs
from mpc_collisionavoidance_tpu.guidance.controller import (
    GuidanceController, Measurements)
from mpc_collisionavoidance_tpu.guidance.waypoints import (
    mission_init, waypoint_manager)
from mpc_collisionavoidance_tpu.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu.ops import integrators
from mpc_collisionavoidance_tpu.solver.batch import (
    LaneRTISolver, LaneState, from_lanes, to_lanes)
from mpc_collisionavoidance_tpu.utils.angles import wrap_once

IPSIED = 4  # ca1 state index of psi_e_d


class FleetState(NamedTuple):
    mission_k: jnp.ndarray        # (B,)
    past_psied: jnp.ndarray       # (B,)
    active: jnp.ndarray           # (B,)
    solver: LaneState             # lane layout
    meas: Measurements            # (B,) fields


class FleetLog(NamedTuple):
    pos: jnp.ndarray       # (T, B, 2)
    ye: jnp.ndarray        # (T, B)
    psi_d: jnp.ndarray     # (T, B)
    active: jnp.ndarray    # (T, B)
    collision: jnp.ndarray # (T, B)
    status: jnp.ndarray    # (T, B) per-tick solver status (0 ok)
    final: FleetState


class FleetMissionEngine:
    """B vehicles, each with its own waypoints and shared obstacle field."""

    def __init__(self, spec: OCPSpec, ipm_iters: int = 10,
                 riccati: str = "lax", **solver_kw):
        """Extra `solver_kw` pass through to LaneRTISolver — e.g. the
        production schedule's centering/extra_iters/ipm_tol
        (config.production_engine())."""
        assert spec.model.name == "usv_guidance_ca1"
        self.spec = spec
        self.solver = LaneRTISolver(spec, ipm_iters=ipm_iters,
                                    riccati=riccati, **solver_kw)
        self._plant = integrators.make_discrete_dynamics(
            spec.model.f, spec.dt, num_steps=4)

    # ------------------------------------------------------------------
    def init_state(self, meas: Measurements, waypoints, n_wp,
                   dtype=jnp.float32) -> FleetState:
        """meas fields (B,); waypoints (B, MAX_WP, 2); n_wp (B,)."""
        meas = Measurements(*[jnp.asarray(m, dtype) for m in meas])
        B = meas.u.shape[0]
        mission = jax.vmap(mission_init, in_axes=(0, 0, 0, None))(
            jnp.asarray(waypoints, dtype), jnp.asarray(n_wp), meas.psi,
            dtype)
        x0 = jax.vmap(GuidanceController._pack_x0, in_axes=(0, 0, None, None))(
            meas, mission.past_psied, jnp.asarray(0.0, dtype),
            jnp.asarray(0.0, dtype))
        return FleetState(
            mission_k=mission.k, past_psied=mission.past_psied,
            active=mission.active,
            solver=self.solver.init_state(x0, dtype=dtype), meas=meas)

    # ------------------------------------------------------------------
    def tick(self, state: FleetState, waypoints, n_wp,
             obstacle_field, field_valid):
        """One 20 Hz tick for the whole fleet (pure; scan over missions)."""
        from mpc_collisionavoidance_tpu.guidance.waypoints import MissionState

        meas = state.meas
        mission = MissionState(k=state.mission_k,
                               past_psied=state.past_psied,
                               active=state.active)
        mission, frame = jax.vmap(waypoint_manager, in_axes=(0, 0, 0, 0, 0))(
            mission, waypoints, n_wp, meas.nedx, meas.nedy)

        # obstacle field either shared, (M, 3), or per-vehicle, (B, M, 3)
        # (randomized-mission sweeps give every vehicle its own field)
        f_ax = 0 if obstacle_field.ndim == 3 else None
        slots = jax.vmap(obs.perceive, in_axes=(f_ax, f_ax, 0, 0, 0))(
            obstacle_field, field_valid, meas.nedx, meas.nedy, meas.psi)

        x0 = jax.vmap(GuidanceController._pack_x0)(
            meas, mission.past_psied, frame.ye, frame.ak)   # (B, nx)

        # --- lane-engine solve (vehicle axis -> minor-most) ---
        solver_state, out = self.solver.step_fn(
            state.solver, to_lanes(x0), to_lanes(slots.p_obs),
            to_lanes(slots.r_obs))
        u0 = from_lanes(out.u0)[:, 0]                        # (B,)
        x1 = from_lanes(out.x1)                              # (B, nx)

        psi_d = wrap_once(x1[:, IPSIED] + frame.ak)
        active = mission.active
        past_psied = jnp.where(active, x1[:, IPSIED], mission.past_psied)

        # --- plant: integrate guidance kinematics; perfect speed loop ---
        x_next = jax.vmap(self._plant, in_axes=(0, 0, None))(
            x0, u0[:, None], jnp.zeros((self.spec.model.np_,), x0.dtype))
        meas_next = Measurements(u=frame.u_d, v=x_next[:, 1],
                                 nedx=x_next[:, 5], nedy=x_next[:, 6],
                                 psi=x_next[:, 7])

        new_state = FleetState(mission_k=mission.k, past_psied=past_psied,
                               active=active, solver=solver_state,
                               meas=meas_next)
        log = (jnp.stack([meas.nedx, meas.nedy], axis=-1), frame.ye,
               psi_d, active, jax.vmap(jnp.any)(slots.collision),
               out.status)
        return new_state, log

    # ------------------------------------------------------------------
    def run(self, meas0: Measurements, waypoints, n_wp,
            obstacle_field, field_valid, n_steps: int = 1200,
            dtype=jnp.float32) -> FleetLog:
        waypoints = jnp.asarray(waypoints, dtype)
        n_wp = jnp.asarray(n_wp)
        obstacle_field = jnp.asarray(obstacle_field, dtype)
        field_valid = jnp.asarray(field_valid, bool)
        state0 = self.init_state(meas0, waypoints, n_wp, dtype=dtype)

        def tick(st, _):
            st, log = self.tick(st, waypoints, n_wp, obstacle_field,
                                field_valid)
            return st, log

        stN, (pos, ye, psi_d, active, collision, status) = jax.lax.scan(
            tick, state0, None, length=n_steps)
        return FleetLog(pos=pos, ye=ye, psi_d=psi_d, active=active,
                        collision=collision, status=status, final=stN)
