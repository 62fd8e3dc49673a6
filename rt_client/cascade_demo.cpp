/* Native two-node cascaded mission: guidance NMPC -> low-level NMPC -> hull.
 *
 * The reference's field configuration runs the guidance CA node at 20 Hz
 * publishing /guidance/desired_{heading,speed} and the low-level thrust
 * node at 100 Hz publishing thruster commands, as two ROS processes
 * against the real boat (SURVEY.md section 3.5; reference
 * src/nmpc_guidance_ca1.cpp + src/nmpc_low_level.cpp).  This demo is that
 * graph natively: the two C++ nodes (nmpc_guidance_node, the waypoint /
 * obstacle / packing state machine; nmpc_low_level_node, the carried-
 * thrust inner loop) each talk to their OWN GPU serving engine over UDS
 * — one started with the flagship model, one with --model usv_low_level
 * — and the vehicle is an honest C++ RK4 integration of the true 3-DOF
 * hydrodynamic hull (reference scripts/usv_pf_ca/usv_model.py:61-77,
 * 137-151 coefficients, c = 0.78 thrust map of scripts/usv_low_level/
 * usv_model.py:77), NOT the solver's own prediction.  The JAX equivalent
 * of this loop is sim/cascade.py (cross-checked in tests/test_cascade.py);
 * this native version proves the deployment topology end-to-end.
 *
 * Usage: cascade_demo <guidance_socket> <lowlevel_socket> [max_gticks]
 * Exit 0 iff every solve transport succeeded, <= 2% of ALL solves
 * (guidance + low-level, 6 per guidance tick) reported a non-converged
 * QP, all four buoys cleared by > 1.1 m at every 100 Hz substep, the
 * hull reached cruise speed, every thrust command stayed inside the
 * model's box bounds, and the vehicle progressed past the buoy line.
 */
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>

#include "nmpc_guidance_node.h"
#include "nmpc_low_level_node.h"

/* ---- true 3-DOF hull (reference scripts/usv_pf_ca/usv_model.py) ---- */
static const double kXudot = -2.25, kYvdot = -23.13, kYrdot = -1.31;
static const double kNvdot = -16.41, kNrdot = -2.79;
static const double kYvv = -99.99, kYvr = -5.49;
static const double kNrv = -8.8, kNrr = -3.49;
static const double kMass = 30.0, kIz = 4.1, kBeam = 0.41;
/* sway-drag factor (reference usv_model.py:139) */
static const double kYvFac = 1.1 + 0.0045 * (1.01 / 0.09) -
                             0.1 * (0.27 / 0.09) +
                             0.016 * (0.27 / 0.09) * (0.27 / 0.09);
static const double kThrustC = 0.78; /* usv_low_level usv_model.py:77 */

struct Hull {
  double psi, u, v, r, x, y;
};

static void hull_deriv(const Hull& h, double tp, double ts, double d[6]) {
  const double tu = tp + kThrustC * ts;
  const double tr = (tp - kThrustC * ts) * kBeam / 2.0;
  const double xu = h.u > 1.25 ? 64.55 : -25.0;
  const double xuu = h.u > 1.25 ? -70.92 : 0.0;
  const double yv = 0.5 * (-40.0 * 1000.0 * fabs(h.v)) * kYvFac;
  const double nr = -0.52 * sqrt(h.u * h.u + h.v * h.v);
  const double du =
      (tu - (-kMass + 2.0 * kYvdot) * h.v - (kYrdot + kNvdot) * h.r * h.r -
       (-xu * h.u - xuu * fabs(h.u) * h.u)) /
      (kMass - kXudot);
  const double dv = (-(kMass - kXudot) * h.u * h.r -
                     (-yv - kYvv * fabs(h.v) - kYvr * fabs(h.r)) * h.v) /
                    (kMass - kYvdot);
  const double dr = (tr -
                     (-2.0 * kYvdot * h.u * h.v -
                      (kYrdot + kNvdot) * h.r * h.u + kXudot * h.u * h.r) -
                     (-nr * h.r - kNrv * fabs(h.v) * h.r -
                      kNrr * fabs(h.r) * h.r)) /
                    (kIz - kNrdot);
  d[0] = h.r;
  d[1] = du;
  d[2] = dv;
  d[3] = dr;
  d[4] = h.u * cos(h.psi) - h.v * sin(h.psi);
  d[5] = h.u * sin(h.psi) + h.v * cos(h.psi);
}

static void hull_rk4(Hull* h, double tp, double ts, double dt) {
  double k1[6], k2[6], k3[6], k4[6];
  Hull t = *h;
  hull_deriv(t, tp, ts, k1);
  t = {h->psi + 0.5 * dt * k1[0], h->u + 0.5 * dt * k1[1],
       h->v + 0.5 * dt * k1[2], h->r + 0.5 * dt * k1[3],
       h->x + 0.5 * dt * k1[4], h->y + 0.5 * dt * k1[5]};
  hull_deriv(t, tp, ts, k2);
  t = {h->psi + 0.5 * dt * k2[0], h->u + 0.5 * dt * k2[1],
       h->v + 0.5 * dt * k2[2], h->r + 0.5 * dt * k2[3],
       h->x + 0.5 * dt * k2[4], h->y + 0.5 * dt * k2[5]};
  hull_deriv(t, tp, ts, k3);
  t = {h->psi + dt * k3[0], h->u + dt * k3[1], h->v + dt * k3[2],
       h->r + dt * k3[3], h->x + dt * k3[4], h->y + dt * k3[5]};
  hull_deriv(t, tp, ts, k4);
  h->psi += dt / 6.0 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]);
  h->u += dt / 6.0 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]);
  h->v += dt / 6.0 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2]);
  h->r += dt / 6.0 * (k1[3] + 2 * k2[3] + 2 * k3[3] + k4[3]);
  h->x += dt / 6.0 * (k1[4] + 2 * k2[4] + 2 * k3[4] + k4[4]);
  h->y += dt / 6.0 * (k1[5] + 2 * k2[5] + 2 * k3[5] + k4[5]);
  if (fabs(h->psi) > M_PI)
    h->psi = (h->psi > 0 ? 1.0 : -1.0) * (fabs(h->psi) - 2.0 * M_PI);
}

/* challenge-0 buoy line (reference obstacle_sim_node.py / main.py:73-75) */
static const float kObs[4][3] = {{4.f, 4.f, 1.5f},
                                 {4.f, 7.f, 1.5f},
                                 {4.f, 12.f, 1.5f},
                                 {4.f, 20.f, 1.5f}};

static int lidar_scan(const gn_measurements* m, float out_xyr[4][3]) {
  int n = 0;
  const float c = cosf(m->psi), s = sinf(m->psi);
  for (int i = 0; i < 4; i++) {
    const float dx = kObs[i][0] - m->nedx, dy = kObs[i][1] - m->nedy;
    if (sqrtf(dx * dx + dy * dy) >= 100.0f) continue;
    out_xyr[n][0] = c * dx + s * dy;
    out_xyr[n][1] = -s * dx + c * dy;
    out_xyr[n][2] = kObs[i][2];
    n++;
  }
  return n;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <guidance_socket> <lowlevel_socket> "
                    "[max_gticks]\n",
            argv[0]);
    return 2;
  }
  const int max_gticks = argc > 3 ? atoi(argv[3]) : 1400;

  nmpc_rt_client* gc = nmpc_rt_connect(argv[1], 30000);
  nmpc_rt_client* lc = nmpc_rt_connect(argv[2], 30000);
  if (!gc || !lc) {
    fprintf(stderr, "connect failed (g=%p l=%p)\n", (void*)gc, (void*)lc);
    return 2;
  }

  const float wps[] = {4.f, -5.f, 4.f, 25.f};
  Hull h = {0.0, 0.001, 0.0, 0.0, 0.0, 0.0};
  gn_node* gn = gn_create(wps, 2, (float)h.psi);
  ll_node ll;
  ll_init(&ll);
  if (!gn) return 2;

  const double ll_dt = 0.01; /* 100 Hz inner loop, 5 subticks per 20 Hz */
  float min_center_dist = 1e30f;
  double max_u = 0.0;
  int bad_status = 0, thrust_violation = 0, gticks = 0;
  uint32_t seq = 1;

  for (int t = 0; t < max_gticks; t++) {
    gn_measurements m = {(float)h.u, (float)h.v, (float)h.x, (float)h.y,
                         (float)h.psi};
    float scan[4][3];
    gn_obstacles(gn, &scan[0][0], lidar_scan(&m, scan), &m);

    gn_commands gcmd;
    if (gn_tick(gn, gc, &m, &gcmd) != 0) {
      fprintf(stderr, "gtick %d: guidance transport failure\n", t);
      return 1;
    }
    if (gcmd.solver_status != 0) bad_status++;

    for (int s = 0; s < 5; s++) {
      ll_measurements lm = {(float)h.psi, (float)h.u, (float)h.v,
                            (float)h.r};
      ll_commands lcmd;
      if (ll_tick(&ll, lc, seq++, &lm, gcmd.psi_d, gcmd.u_d, &lcmd) != 0) {
        fprintf(stderr, "gtick %d.%d: low-level transport failure\n", t, s);
        return 1;
      }
      if (lcmd.solver_status != 0) bad_status++;
      /* usv_low_level thrust box (reference usv_model.py:133-136) */
      if (lcmd.t_port > 35.0f + 1e-4f || lcmd.t_port < -30.0f - 1e-4f ||
          lcmd.t_stbd > 35.0f + 1e-4f || lcmd.t_stbd < -30.0f - 1e-4f)
        thrust_violation++;
      hull_rk4(&h, lcmd.t_port, lcmd.t_stbd, ll_dt);

      /* clearance / speed sampled at every 100 Hz substep so a closest
       * approach between guidance ticks cannot go unmeasured */
      if (h.u > max_u) max_u = h.u;
      for (int i = 0; i < 4; i++) {
        const float d =
            sqrtf((float)((h.x - kObs[i][0]) * (h.x - kObs[i][0]) +
                          (h.y - kObs[i][1]) * (h.y - kObs[i][1])));
        if (d < min_center_dist) min_center_dist = d;
      }
    }

    if (t % 100 == 0)
      printf("gtick %d pos (%.2f, %.2f) psi %.2f u %.2f psi_d %.2f ye %.3f "
             "active %d\n",
             t, h.x, h.y, h.psi, h.u, gcmd.psi_d, gcmd.ye, gcmd.active);
    gticks = t + 1;
    if (!gcmd.active || h.y > 22.0) break; /* mission end / past the line */
  }

  /* total solves = gticks guidance + 5*gticks low-level */
  const int total = gticks * 6;
  const int progressed = h.y > 20.0;
  printf("gticks %d pos (%.2f, %.2f) max_u %.2f min_center_dist %.3f "
         "bad_status %d/%d thrust_violations %d progressed %d\n",
         gticks, h.x, h.y, max_u, min_center_dist, bad_status, total,
         thrust_violation, progressed);
  gn_destroy(gn);
  nmpc_rt_close(gc);
  nmpc_rt_close(lc);
  const int ok = progressed && max_u > 0.6 && bad_status * 50 <= total &&
                 thrust_violation == 0 && min_center_dist > 1.1f;
  return ok ? 0 : 1;
}
