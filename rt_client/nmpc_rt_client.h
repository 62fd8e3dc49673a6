/* Real-time C++ client for the GPU NMPC serving engine.
 *
 * Native counterpart of the reference's node-side solver boundary: where
 * the reference C++ node calls the generated acados_solve() in-process
 * (reference catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp:577), a
 * GPU deployment calls nmpc_rt_solve() against the serving engine
 * (mpc_collisionavoidance_tpu/rt/server.py) over a Unix-domain socket.
 * Frame layout mirrors rt/protocol.py byte-for-byte (little-endian).
 *
 * Usage:
 *   nmpc_rt_client* c = nmpc_rt_connect("/tmp/nmpc_rt.sock", 50);
 *   nmpc_rt_request  req  = {...};
 *   nmpc_rt_response resp;
 *   int rc = nmpc_rt_solve(c, &req, &resp);   // 0 ok, <0 error/timeout
 *   nmpc_rt_close(c);
 *
 * The C ABI keeps the library loadable from any stack (C++, ctypes, Rust
 * FFI) without name mangling.
 */
#ifndef NMPC_RT_CLIENT_H_
#define NMPC_RT_CLIENT_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NMPC_RT_NX 8
#define NMPC_RT_NP 16
#define NMPC_RT_NH 8
#define NMPC_RT_REQ_MAGIC 0x4E4D5043u  /* "NMPC" */
#define NMPC_RT_RESP_MAGIC 0x4E4D5052u /* "NMPR" */

#pragma pack(push, 1)
typedef struct {
  uint32_t magic; /* NMPC_RT_REQ_MAGIC */
  uint32_t seq;
  float x0[NMPC_RT_NX];
  float p_obs[NMPC_RT_NP];
  float r_obs[NMPC_RT_NH];
} nmpc_rt_request;

typedef struct {
  uint32_t magic; /* NMPC_RT_RESP_MAGIC */
  uint32_t seq;
  uint32_t status; /* 0 ok / 1 qp not converged / 2 numerical failure /
                      3 fleet over capacity (lane engine: retry after a
                      vehicle disconnects; command fields are zeros) */
  float u0;
  float x1[NMPC_RT_NX];
} nmpc_rt_response;
#pragma pack(pop)

typedef struct nmpc_rt_client nmpc_rt_client;

/* Connect to the serving engine. `socket_path` is either a Unix-domain
 * socket path (same-host) or "host:port" for TCP (cross-machine — the
 * reference's networked TCPROS boundary; TCP_NODELAY is set).
 * timeout_ms bounds each solve round trip (the 20 Hz real-time budget is
 * 50 ms). Returns NULL on failure. */
nmpc_rt_client* nmpc_rt_connect(const char* socket_path, int timeout_ms);

/* One blocking solve tick. Fills *resp. Returns 0 on success,
 * -1 socket error, -2 timeout, -3 protocol error (bad magic or stale
 * seq). On timeout the connection is left in an indeterminate framing
 * state; callers should reconnect, mirroring how the reference keeps the
 * STALE previous command on solver failure rather than acting on partial
 * results (reference nmpc_guidance_ca1.cpp:577-580). */
int nmpc_rt_solve(nmpc_rt_client* c, const nmpc_rt_request* req,
                  nmpc_rt_response* resp);

void nmpc_rt_close(nmpc_rt_client* c);

/* ------------------------------------------------------------------------
 * Protocol v2: variant-generic frames (mirrors rt/protocol.py v2).
 *
 * The v1 frames above are the flagship node's boundary. v2 serves ANY
 * model in the zoo: the request header carries the client's dims, the
 * server validates them against the model it was started with
 * (`rt.server --model usv_pf` etc.) and answers
 * NMPC_RT_STATUS_BAD_REQUEST on mismatch. The payload optionally carries
 * a stage-constant yref (ny = 0 uses the server's builder references),
 * matching how the reference nodes push yref every tick
 * (src/nmpc_low_level.cpp:206-248).
 */
#define NMPC_RT_REQ2_MAGIC 0x4E4D5032u  /* "NMP2" */
#define NMPC_RT_RESP2_MAGIC 0x4E4D5233u /* "NMR3" */
#define NMPC_RT_STATUS_OVER_CAPACITY 3u
#define NMPC_RT_STATUS_BAD_REQUEST 4u

/* stable wire ids (mirrors protocol.MODEL_IDS) */
enum nmpc_rt_model_id {
  NMPC_RT_MODEL_GUIDANCE_CA1 = 1,
  NMPC_RT_MODEL_GUIDANCE_CA = 2,
  NMPC_RT_MODEL_GUIDANCE = 3,
  NMPC_RT_MODEL_GUIDANCE2 = 4,
  NMPC_RT_MODEL_GUIDANCE3 = 5,
  NMPC_RT_MODEL_GUIDANCE4 = 6,
  NMPC_RT_MODEL_GUIDANCE5 = 7,
  NMPC_RT_MODEL_LOW_LEVEL = 8,
  NMPC_RT_MODEL_PF = 9,
  NMPC_RT_MODEL_PF_CA = 10,
  NMPC_RT_MODEL_ACADOS = 11,
  NMPC_RT_MODEL_POSITION_CONTROL = 12,
  NMPC_RT_MODEL_RACE_CARS = 13,
  NMPC_RT_MODEL_RACE_CARS_DEV = 14,
};

/* One blocking v2 solve tick for a model with runtime dims.
 *   x0:    float[nx]          measured state
 *   p:     float[np]  (np may be 0)   stage parameters
 *   lh:    float[nh]  (nh may be 0)   runtime lower bounds
 *   yref:  float[ny]  (ny may be 0 -> server's builder references)
 *   u0:    float[nu_cap] out          stage-0 command vector
 *   x1:    float[nx] out              stage-1 predicted state
 *   status/out_nu: out
 * Returns 0 on success (including BAD_REQUEST replies — check *status),
 * -1 socket error, -2 timeout, -3 protocol error, -4 reply dims exceed
 * the caller's buffers. */
int nmpc_rt_solve2(nmpc_rt_client* c, uint16_t model_id, uint32_t seq,
                   const float* x0, uint16_t nx, const float* p,
                   uint16_t np, const float* lh, uint16_t nh,
                   const float* yref, uint16_t ny, float* u0,
                   uint16_t nu_cap, float* x1, uint32_t* status,
                   uint16_t* out_nu);

#ifdef __cplusplus
}
#endif

#endif /* NMPC_RT_CLIENT_H_ */
