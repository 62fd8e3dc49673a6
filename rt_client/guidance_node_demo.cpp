/* Full-mission closed-loop demo of the NATIVE guidance node.
 *
 * This is the reference's multi-process ROS graph — obstacle_sim_node
 * fake LiDAR (reference catkin_ws/src/simulation/scripts/
 * obstacle_sim_node.py) + the nmpc_guidance_ca1 node (reference
 * src/nmpc_guidance_ca1.cpp) — collapsed into one native process that
 * talks to the GPU serving engine over the UDS boundary:
 *
 *   world obstacle field -> visibility cull + NED->body (fake LiDAR)
 *     -> gn_obstacles intake -> gn_tick (waypoint manager, crab-angle
 *        packing, rt solve, command extraction)
 *     -> plant: stage-1 prediction + perfect speed loop u <- u_d
 *        (the solver-as-plant idiom of reference main.py:169-174 with the
 *        mission-stopping speed loop of sim/mission.py)
 *
 * Mission: two legs (4,-5) -> (4,25) -> (20,25); four r = 1.5 buoys ON
 * the first leg (reference scripts/usv_guidance_ca1/main.py:73-75) so the
 * node must deviate around them, then capture the corner waypoint, switch
 * segments (heading-error re-projection) and finish the second leg.
 *
 * Usage: guidance_node_demo <socket_path> [max_ticks]
 * Exit 0 iff every solve transport succeeded, <= 2% of ticks reported a
 * non-converged QP (the reference's own loop keeps the stale command and
 * continues on nonzero acados status, reference :577-580), all four
 * buoys were cleared by > 1.3 m center distance, the segment switch
 * happened, and the mission went inactive (final waypoint captured).
 */
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>

#include "nmpc_guidance_node.h"

static const float kObs[4][3] = {/* x, y, r (world NED) */
                                 {4.f, 4.f, 1.5f},
                                 {4.f, 7.f, 1.5f},
                                 {4.f, 12.f, 1.5f},
                                 {4.f, 20.f, 1.5f}};
static const float kVisible = 100.0f; /* obstacle_sim_node.py:43 */

/* Fake LiDAR (reference obstacle_sim_node.py:55-81,100-115): world ->
 * body-frame (x, y, r) triples within visibility radius. */
static int lidar_scan(const gn_measurements* m, float out_xyr[4][3]) {
  int n = 0;
  const float c = cosf(m->psi), s = sinf(m->psi);
  for (int i = 0; i < 4; i++) {
    const float dx = kObs[i][0] - m->nedx, dy = kObs[i][1] - m->nedy;
    if (sqrtf(dx * dx + dy * dy) >= kVisible) continue;
    out_xyr[n][0] = c * dx + s * dy; /* R(psi)^T [dx, dy] */
    out_xyr[n][1] = -s * dx + c * dy;
    out_xyr[n][2] = kObs[i][2];
    n++;
  }
  return n;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <socket_path> [max_ticks]\n", argv[0]);
    return 2;
  }
  const int max_ticks = argc > 2 ? atoi(argv[2]) : 2500;

  nmpc_rt_client* c = nmpc_rt_connect(argv[1], /*timeout_ms=*/5000);
  if (!c) {
    fprintf(stderr, "connect(%s) failed\n", argv[1]);
    return 2;
  }

  const float wps[] = {4.f, -5.f, 4.f, 25.f, 20.f, 25.f};
  gn_measurements m = {0.7f, 0.0f, 0.0f, 0.0f, 0.0f};
  gn_node* node = gn_create(wps, 3, m.psi);
  if (!node) return 2;

  float min_center_dist = 1e30f;
  int switched = 0, bad_status = 0, ticks = 0;
  double worst_us = 0;
  float prev_target_x = wps[2];

  for (int t = 0; t < max_ticks; t++) {
    float scan[4][3];
    const int n_obs = lidar_scan(&m, scan);
    gn_obstacles(node, &scan[0][0], n_obs, &m);

    gn_commands cmd;
    auto t0 = std::chrono::steady_clock::now();
    const int rc = gn_tick(node, c, &m, &cmd);
    const double us = std::chrono::duration<double, std::micro>(
                          std::chrono::steady_clock::now() - t0)
                          .count();
    if (us > worst_us) worst_us = us;
    if (rc != 0) {
      fprintf(stderr, "tick %d: transport rc=%d\n", t, rc);
      nmpc_rt_close(c);
      return 1;
    }
    if (cmd.solver_status != 0) bad_status++;
    if (cmd.target[0] != prev_target_x) switched = 1;

    /* honest plant (the sim/mission.py idiom): integrate the guidance
     * kinematics (reference usv_model.py:117-128) one tick under the
     * commanded heading.  In measurement terms the model's heading law
     * psi_dot = (psi_e_d - psi_e)/T1 with psi_e = psi - ak is exactly
     * psi_dot = (psi_d - psi)/T1, T1 = 1.0; surge tracks u_d through a
     * perfect speed loop so the mission can stop; v has no dynamics in
     * the kinematic model. */
    const float dt = 0.05f;
    float dpsi = cmd.psi_d - m.psi;
    if (fabsf(dpsi) > (float)M_PI)
      dpsi = (dpsi > 0 ? 1.0f : -1.0f) * (fabsf(dpsi) - 2.0f * (float)M_PI);
    m.nedx += dt * (m.u * cosf(m.psi) - m.v * sinf(m.psi));
    m.nedy += dt * (m.u * sinf(m.psi) + m.v * cosf(m.psi));
    m.psi += dt * dpsi / 1.0f;
    if (fabsf(m.psi) > (float)M_PI)
      m.psi = (m.psi > 0 ? 1.0f : -1.0f) * (fabsf(m.psi) - 2.0f * (float)M_PI);
    m.u = cmd.u_d;

    for (int i = 0; i < 4; i++) {
      const float d = sqrtf((m.nedx - kObs[i][0]) * (m.nedx - kObs[i][0]) +
                            (m.nedy - kObs[i][1]) * (m.nedy - kObs[i][1]));
      if (d < min_center_dist) min_center_dist = d;
    }

    if (t % 200 == 0)
      printf("tick %d pos (%.2f, %.2f) psi %.2f ye %.3f psi_d %.2f "
             "u_d %.1f active %d\n",
             t, m.nedx, m.nedy, m.psi, cmd.ye, cmd.psi_d, cmd.u_d,
             cmd.active);
    ticks = t + 1;
    if (!cmd.active) break; /* final waypoint captured */
  }

  const int done = ticks < max_ticks;
  printf("ticks %d switched %d min_center_dist %.3f bad_status %d "
         "worst_latency_us %.0f done %d\n",
         ticks, switched, min_center_dist, bad_status, worst_us, done);
  nmpc_rt_close(c);
  const int ok = done && switched && bad_status * 50 <= ticks &&
                 min_center_dist > 1.3f;
  return ok ? 0 : 1;
}
