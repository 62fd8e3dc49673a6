"""Waypoint-manager mission state machine as a pure, vmappable function.

Re-implements the behavior of the reference node's `waypoint_manager()`
(reference catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp:441-491) and the
mission (re)seed logic of its main loop (same file :615-632) with
fixed-shape, data-dependent-branch-free JAX so a whole *fleet* of missions
batches under `vmap`:

- waypoints are a fixed-capacity (MAX_WP, 2) table plus a live count `n_wp`
  (the device-program analog of the variable-length Float32MultiArray topic);
- the current segment index ``k`` (reference member ``k``, segments are
  (wp[k-1] -> wp[k])), the carried heading-error command memory
  ``past_psied`` (reference :593) and mission activity are an explicit
  `MissionState` carry;
- segment advance happens when the distance to the segment end drops below
  1 m (reference :449-452,467-469); on advance the carried heading error is
  re-projected into the new segment frame, past_psied += ak_old - ak_new,
  wrapped (reference :478-484);
- deviation from the reference: advancing past the FINAL waypoint flips the
  mission inactive instead of reading one segment past the table (the C++
  indexes `last_waypoints[2k+1]` beyond the vector on the last advance —
  undefined behavior we do not reproduce).  Inactive missions command
  u_d = 0 (reference :487-490).
"""

from typing import NamedTuple

import jax.numpy as jnp

from mpc_collisionavoidance_tpu.utils.angles import wrap_once

CRUISE_SPEED = 0.7       # d_speed while active (reference :452)
WP_CAPTURE_RADIUS = 1.0  # segment-advance distance (reference :455)


class MissionState(NamedTuple):
    k: jnp.ndarray           # current segment index (int32), segment wp[k-1]->wp[k]
    past_psied: jnp.ndarray  # carried psi_e_d command memory (reference :593)
    active: jnp.ndarray      # bool; False once the final waypoint is reached


class SegmentFrame(NamedTuple):
    """Path frame handed to the controller (reference control() args :493)."""
    x1: jnp.ndarray      # segment start
    y1: jnp.ndarray
    ak: jnp.ndarray      # segment angle atan2(y2-y1, x2-x1) (reference :451)
    ye: jnp.ndarray      # cross-track error (reference :457-458)
    target: jnp.ndarray  # (2,) segment end waypoint (published target, :453)
    u_d: jnp.ndarray     # commanded surge speed (0.7 active / 0.0 done)
    advanced: jnp.ndarray  # bool: segment switch happened this tick


def mission_init(waypoints, n_wp, psi, dtype=jnp.float32) -> MissionState:
    """Seed a mission the way the node reacts to a NEW waypoint list
    (reference :616-632): k = 1 and past_psied = wrap(psi - ak_first)."""
    wp = jnp.asarray(waypoints, dtype)
    ak0 = jnp.arctan2(wp[1, 1] - wp[0, 1], wp[1, 0] - wp[0, 0])
    return MissionState(
        k=jnp.asarray(1, jnp.int32),
        past_psied=wrap_once(jnp.asarray(psi, dtype) - ak0),
        active=jnp.asarray(n_wp, jnp.int32) >= 2,
    )


def _segment(wp, k):
    """Gather segment (wp[k-1] -> wp[k]) quantities; indices are clipped by
    jnp gather semantics so out-of-range k degrades gracefully."""
    p1 = wp[k - 1]
    p2 = wp[k]
    ak = jnp.arctan2(p2[1] - p1[1], p2[0] - p1[0])
    return p1, p2, ak


def waypoint_manager(state: MissionState, waypoints, n_wp, nedx, nedy):
    """One mission-manager tick. Returns (new_state, SegmentFrame).

    All branches are `jnp.where` selections: the solver downstream always
    runs; inactive missions just mask the commands, which is the
    compiled-once replacement for the node's early return (:486-490).
    """
    wp = jnp.asarray(waypoints)
    n_wp = jnp.asarray(n_wp, jnp.int32)
    k = state.k

    p1, p2, ak = _segment(wp, k)
    dist = jnp.hypot(p2[0] - nedx, p2[1] - nedy)

    # advance only while a further segment exists (see module docstring)
    can_advance = (k + 1) < n_wp
    advance = (dist <= WP_CAPTURE_RADIUS) & can_advance & state.active
    finish = (dist <= WP_CAPTURE_RADIUS) & ~can_advance & state.active

    k_new = jnp.where(advance, k + 1, k)
    p1n, p2n, ak_new = _segment(wp, k_new)
    # heading-error re-projection across the segment switch (reference :478-484)
    past_psied = jnp.where(
        advance, wrap_once(state.past_psied - ak_new + ak), state.past_psied)

    active = state.active & ~finish
    ye = (-(nedx - p1n[0]) * jnp.sin(ak_new)
          + (nedy - p1n[1]) * jnp.cos(ak_new))

    frame = SegmentFrame(
        x1=p1n[0], y1=p1n[1], ak=ak_new, ye=ye,
        target=p2n,
        u_d=jnp.where(active, CRUISE_SPEED, 0.0).astype(wp.dtype),
        advanced=advance,
    )
    return MissionState(k=k_new, past_psied=past_psied, active=active), frame
