/* Native low-level (inner-loop) thrust node for the usv_low_level NMPC.
 *
 * C++ re-build of the reference's 100 Hz speed+heading controller node
 * (reference catkin_ws/src/nmpc_ca/src/nmpc_low_level.cpp, 304 LoC):
 * everything that node does AROUND the solver call — packing the 8-state
 * x0 with the CARRIED past thrust commands (thrusts are states because
 * the OCP inputs are thrust rates, reference :206-215), the per-tick
 * yref = (psi_d, sin psi_d, cos psi_d, u_d, 0...) reference push
 * (:221-246), thrust extraction from the STAGE-1 state (:257-260), the
 * hard zero override when the commanded speed is 0 (:262-265), the
 * carried-thrust memory update (:268-269) and the e_u/e_psi/Tx/Tz
 * telemetry with the c = 0.78 asymmetric thrust map (:273-285).
 *
 * The solve crosses the nmpc_rt_client v2 UDS boundary to the GPU serving
 * engine started as `rt.server --model usv_low_level` (the acados_solve()
 * seam of the reference, :249).  The same logic exists in JAX
 * (mpc_collisionavoidance_tpu/guidance/low_level.py) for fleet-batched
 * simulation; both are cross-checked tick-for-tick in
 * tests/test_low_level_node_cpp.py.
 *
 * C ABI, no dependencies beyond libm; loadable via ctypes.
 */
#ifndef NMPC_LOW_LEVEL_NODE_H_
#define NMPC_LOW_LEVEL_NODE_H_

#include <stdint.h>

#include "nmpc_rt_client.h"

#ifdef __cplusplus
extern "C" {
#endif

#define LL_NX 8       /* psi, sin psi, cos psi, u, v, r, Tport, Tstbd */
#define LL_NY 10      /* states + (UTportdot, UTstbddot) */
#define LL_THRUST_C 0.78f /* starboard asymmetry (reference usv_model.py:77) */
#define LL_BEAM 0.41f     /* hull beam B (reference usv_model.py:76) */

/* INS measurements (reference velocity/position callbacks :176-193,
 * including the u == 0 -> 0.001 guard of :180-182). */
typedef struct {
  float psi;     /* heading */
  float u, v, r; /* body-frame surge/sway velocity + yaw rate */
} ll_measurements;

/* Published outputs of one tick (reference :257-285). */
typedef struct {
  float t_port, t_stbd; /* thruster commands (zeroed when u_d == 0) */
  float e_u, e_psi;     /* speed / heading error telemetry */
  float tx, tz;         /* Tx = Tp + c*Ts ; Tz = (Tp - c*Ts)*B/2 */
  uint32_t solver_status;
} ll_commands;

/* Node state: the carried thrust command memory.  Plain struct (no
 * opaque allocation) — the node has no mission machinery. */
typedef struct {
  float past_t_port, past_t_stbd; /* reference :268-269 */
  int have_cmd;                   /* stale-command fallback availability */
  ll_commands last;
} ll_node;

void ll_init(ll_node* n);

/* --- pure sub-steps, exposed for testing / custom transports --- */

/* Pack the OCP initial state from measurements + carried thrusts
 * (reference :206-215). */
void ll_pack_x0(const ll_node* n, const ll_measurements* meas,
                float x0[LL_NX]);

/* Per-tick stage reference (reference :221-240).  yref_e is the first 8
 * entries of the same vector. */
void ll_pack_yref(float psi_d, float u_d, float yref[LL_NY]);

/* Command extraction from the stage-1 predicted state: thrust +
 * zero-speed override + carried memory + telemetry (reference :257-285).
 * Updates n->past_* from x1 BEFORE the override (the reference stores
 * x1 thrusts unconditionally, :268-269). */
void ll_extract(ll_node* n, const float x1[LL_NX], uint32_t status,
                const ll_measurements* meas, float psi_d, float u_d,
                ll_commands* out);

/* One 100 Hz control tick against the serving engine (v2 frames,
 * model usv_low_level).  On transport failure (rc != 0) the PREVIOUS
 * commands are returned with solver_status = 0xFFFFFFFF, mirroring how
 * the reference keeps the stale command on a failed solve.  Returns the
 * client rc. */
int ll_tick(ll_node* n, nmpc_rt_client* c, uint32_t seq,
            const ll_measurements* meas, float psi_d, float u_d,
            ll_commands* out);

#ifdef __cplusplus
}
#endif

#endif /* NMPC_LOW_LEVEL_NODE_H_ */
