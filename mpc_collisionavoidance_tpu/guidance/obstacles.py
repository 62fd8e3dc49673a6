"""Obstacle perception intake: fixed-shape, sort-free top-8 selection.

Re-implements two reference components as pure JAX:

- the fake-LiDAR visibility model of the simulation package
  (reference catkin_ws/src/simulation/scripts/obstacle_sim_node.py:55-81):
  cull the world obstacle field to a 100 m visibility radius around the
  vehicle and express survivors in the body frame;
- the flagship node's `obstaclesCallback` intake (reference
  catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp:252-346): inflate each
  radius by the boat radius, keep the 8 closest by surface distance
  sqrt(x^2+y^2) - r_inflated (std::sort in `sortVec` :422-438), transform
  back to NED (`body2NED` :348-363), flag collisions (distance < inflated
  radius -> ROS_WARN :321-326), and pad unused solver slots with the
  far-away sentinel (`initializeObstacles` :365-376).

Device-program differences:
- the world field is a fixed-capacity (M, 3) table (X, Y, R) + validity
  mask — variable-length ROS messages become masked lanes;
- `std::sort` becomes `jax.lax.top_k` over negated distances (selection,
  not ordering, is what the solver needs; slot order still ends up
  closest-first like the reference's sorted fill);
- the reference only sorts when len > 8 and otherwise fills in message
  order; the selected *constraint set* is identical either way, which is
  the contract the solver consumes.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

BOAT_RADIUS = 0.5      # reference nmpc_guidance_ca1.cpp:139
N_SLOTS = 8            # obs_num_, :140
SENTINEL_POS = 1000.0  # init_obs_pos_, :141
VISIBLE_RADIUS = 100.0 # obstacle_sim_node.py:43
FAR = 1e9              # masked-lane distance key


class ObstacleSlots(NamedTuple):
    """What the solver consumes each tick (reference control() :539-565)."""
    p_obs: jnp.ndarray      # (2*N_SLOTS,) NED centers, sentinel-padded
    r_obs: jnp.ndarray      # (N_SLOTS,) inflated radii (runtime `lh`)
    collision: jnp.ndarray  # (N_SLOTS,) bool: vehicle inside inflated radius
    n_visible: jnp.ndarray  # () int32 visible count before truncation


def lidar_scan(field, field_valid, nedx, nedy, psi):
    """World field -> body-frame detections with visibility culling.

    field: (M, 3) NED (X, Y, R); field_valid: (M,) bool.
    Returns (body_xy (M, 2), radius (M,), visible (M,) bool).
    Mirrors obstacle_sim_node.simulate + ned_to_body (reference
    obstacle_sim_node.py:55-81,100-115).
    """
    field = jnp.asarray(field)
    dx = field[:, 0] - nedx
    dy = field[:, 1] - nedy
    visible = (jnp.hypot(dx, dy) < VISIBLE_RADIUS) & field_valid
    c, s = jnp.cos(psi), jnp.sin(psi)
    bx = c * dx + s * dy      # R(psi)^T [dx, dy]
    by = -s * dx + c * dy
    return jnp.stack([bx, by], axis=-1), field[:, 2], visible


def intake(body_xy, radius, visible, nedx, nedy, psi,
           boat_radius: float = BOAT_RADIUS,
           n_slots: int = N_SLOTS) -> ObstacleSlots:
    """Body-frame detections -> fixed solver slots (closest-first, padded).

    body_xy: (M, 2), radius: (M,), visible: (M,) bool.
    """
    body_xy = jnp.asarray(body_xy)
    dtype = body_xy.dtype
    r_infl = radius + boat_radius
    center_dist = jnp.hypot(body_xy[:, 0], body_xy[:, 1])
    # surface distance used as the sort key (reference :267-269)
    key = jnp.where(visible, center_dist - r_infl, FAR)

    _, idx = jax.lax.top_k(-key, n_slots)          # n_slots smallest keys
    sel_valid = visible[idx]
    sel_xy = body_xy[idx]
    sel_r = jnp.where(sel_valid, r_infl[idx], 0.0)

    # body -> NED (reference body2NED :348-363)
    c, s = jnp.cos(psi), jnp.sin(psi)
    ox = c * sel_xy[:, 0] - s * sel_xy[:, 1] + nedx
    oy = s * sel_xy[:, 0] + c * sel_xy[:, 1] + nedy
    ox = jnp.where(sel_valid, ox, SENTINEL_POS)
    oy = jnp.where(sel_valid, oy, SENTINEL_POS)

    collision = sel_valid & (center_dist[idx] < r_infl[idx])
    p_obs = jnp.stack([ox, oy], axis=-1).reshape(2 * n_slots).astype(dtype)
    return ObstacleSlots(
        p_obs=p_obs,
        r_obs=sel_r.astype(dtype),
        collision=collision,
        n_visible=jnp.sum(visible.astype(jnp.int32)),
    )


def perceive(field, field_valid, nedx, nedy, psi,
             boat_radius: float = BOAT_RADIUS,
             n_slots: int = N_SLOTS) -> ObstacleSlots:
    """Full perception pipeline: world field -> solver slots (one fused op)."""
    body_xy, radius, visible = lidar_scan(field, field_valid, nedx, nedy, psi)
    return intake(body_xy, radius, visible, nedx, nedy, psi,
                  boat_radius=boat_radius, n_slots=n_slots)
