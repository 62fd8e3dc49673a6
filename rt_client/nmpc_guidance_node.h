/* Native guidance node for the flagship usv_guidance_ca1 controller.
 *
 * This is the C++ re-build of the reference's flagship real-time node
 * (reference catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp, 640 LoC):
 * everything that node does AROUND the solver call — the waypoint-manager
 * mission state machine (:441-491), the LiDAR obstacle intake with
 * closest-first truncation to 8 slots (:252-346, sortVec :422-438,
 * body2NED :348-363, sentinel fill :365-376), the crab-angle OCP state
 * packing (:495-516) and the command extraction from the stage-1
 * prediction (:583-600) — runs natively here, while the solve itself
 * crosses the nmpc_rt_client UDS boundary to the GPU serving engine
 * (the acados_solve() seam of the reference, :577).
 *
 * The same logic exists in JAX (mpc_collisionavoidance_tpu/guidance/) for
 * fleet-batched simulation; this native version is for the vehicle side of
 * a deployment, where the autopilot stack is C++ and the per-tick math
 * must run without a Python runtime.  Both implementations follow the
 * reference's conventions (wrap-once angle idiom, u==0 -> 0.001 crab
 * guard, boat_radius 0.5 inflation, 1000 m sentinels) so they are
 * cross-checked against each other in tests/test_guidance_node_cpp.py.
 *
 * C ABI, no dependencies beyond libm; loadable via ctypes.
 */
#ifndef NMPC_GUIDANCE_NODE_H_
#define NMPC_GUIDANCE_NODE_H_

#include <stdint.h>

#include "nmpc_rt_client.h"

#ifdef __cplusplus
extern "C" {
#endif

#define GN_MAX_WP 64
#define GN_N_SLOTS 8
#define GN_BOAT_RADIUS 0.5f   /* reference :139 */
#define GN_SENTINEL 1000.0f   /* init_obs_pos_, reference :141 */
#define GN_CAPTURE_RADIUS 1.0f /* segment-advance distance, reference :455 */
#define GN_CRUISE_SPEED 0.7f  /* d_speed while active, reference :452 */

/* INS measurements (reference velocity/position callbacks :223-241). */
typedef struct {
  float u, v;          /* body-frame surge/sway velocity */
  float nedx, nedy;    /* NED position */
  float psi;           /* heading */
} gn_measurements;

/* Published outputs of one tick (reference :587-600). */
typedef struct {
  float psi_d;     /* desired heading = x1[psi_e_d] + ak, wrapped */
  float r_d;       /* desired yaw rate = u0 */
  float u_d;       /* desired speed: 0.7 cruising / 0.0 mission done */
  float ye;        /* cross-track error (telemetry) */
  float target[2]; /* current target waypoint */
  int collision;   /* any obstacle slot in collision this tick */
  uint32_t solver_status;
  int active;      /* mission still running */
} gn_commands;

typedef struct gn_node gn_node; /* opaque */

/* Create a node with a waypoint list (x0,y0,x1,y1,... pairs, n_wp >= 2)
 * and the current heading (seeds past_psied = wrap(psi - ak_first),
 * reference :616-632).  Returns NULL on bad args. */
gn_node* gn_create(const float* waypoints_xy, int n_wp, float psi);
void gn_destroy(gn_node* n);

/* Replace the mission waypoints mid-run: re-seeds k = 1 and past_psied,
 * exactly the node's waypoint-change detection (reference :616-632). */
int gn_set_waypoints(gn_node* n, const float* waypoints_xy, int n_wp,
                     float psi);

/* Obstacle intake from a body-frame detection list (x, y, radius triples,
 * the obstacles_list msg of the reference simulation package): keeps the
 * 8 closest by surface distance |p| - (r + boat_radius), inflates radii,
 * transforms to NED, pads free slots with far-away sentinels
 * (reference obstaclesCallback :252-346).  Call at perception rate; the
 * slots persist until the next call.  Returns the number of slots in
 * collision (vehicle inside an inflated radius, reference :321-326). */
int gn_obstacles(gn_node* n, const float* body_xyr, int n_obs,
                 const gn_measurements* meas);

/* One 20 Hz control tick against the serving engine: waypoint manager ->
 * crab-angle packing -> nmpc_rt_solve -> command extraction.  On solver
 * transport failure (rc != 0) the PREVIOUS commands are returned with
 * solver_status = 0xFFFFFFFF, mirroring how the reference keeps the stale
 * command on a failed solve (:577-580).  Returns the client rc. */
int gn_tick(gn_node* n, nmpc_rt_client* c, const gn_measurements* meas,
            gn_commands* out);

/* --- pure sub-steps, exposed for testing / custom transports --- */

/* Waypoint-manager tick + OCP packing (no solve): fills x0[8], p_obs[16],
 * r_obs[8] and writes frame outputs (ye, ak, target, u_d, active) into
 * *out.  Returns 1 while the mission is active. */
int gn_pack(gn_node* n, const gn_measurements* meas, float x0[NMPC_RT_NX],
            float p_obs[NMPC_RT_NP], float r_obs[NMPC_RT_NH],
            gn_commands* out);

/* Command extraction from a solve result (stage-1 state + stage-0 input),
 * updating the carried past_psied memory (reference :583-600). */
void gn_extract(gn_node* n, const float x1[NMPC_RT_NX], float u0,
                gn_commands* out);

#ifdef __cplusplus
}
#endif

#endif /* NMPC_GUIDANCE_NODE_H_ */
