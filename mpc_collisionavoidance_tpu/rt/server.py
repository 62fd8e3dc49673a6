"""Real-time serving engine: UDS/TCP server around the jitted RTI solver.

Plays the role the generated `acados_solve()` + node main loop play in the
reference (one low-latency solve per 20 Hz tick per vehicle,
SURVEY.md section 3.1), re-shaped for a device runtime:

- each client connection is one vehicle; its SQP-RTI warm start
  (`SolverState`) is held server-side between ticks, exactly like acados
  keeping its primal iterate in process memory (SURVEY.md section 5,
  checkpoint/resume);
- requests from concurrent vehicles within a batching window are packed
  into ONE device program call (the latency/throughput middle path of
  BASELINE.md: a fleet of 20 Hz vehicles shares the chip);
- the asyncio loop is the transport; compute never blocks it for other
  clients while a batch is in flight.

Transports (same frame protocol on both):
- Unix domain socket (default): same-host clients, lowest overhead.
- TCP (`host:port` address, e.g. `0.0.0.0:8490`): the cross-machine
  deployment boundary — the reference's nodes talk networked ROS TCPROS
  (reference src/nmpc_guidance_ca1.cpp:172-184), so a boat computer can
  reach a GPU host the same way here.  TCP_NODELAY is set per connection.

Run standalone:  python -m mpc_collisionavoidance_tpu.rt.server /tmp/nmpc.sock
           or :  python -m mpc_collisionavoidance_tpu.rt.server 0.0.0.0:8490
"""

import asyncio
import concurrent.futures
import dataclasses
import logging
import threading
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpc_collisionavoidance_tpu.config import RICCATI_BACKENDS
from mpc_collisionavoidance_tpu.ocp import builders
from mpc_collisionavoidance_tpu.rt import protocol
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver, SolverState
from mpc_collisionavoidance_tpu.utils.device import enable_compile_cache

#: reply status when a lane-engine fleet is at capacity (all lanes taken);
#: distinct from the solver's 0 ok / 1 not converged / 2 NaN codes
STATUS_OVER_CAPACITY = 3

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Vehicle:
    state: SolverState
    seq: int = 0
    prepared_qp: object = None   # RTI-split: linearization for the NEXT tick


@dataclasses.dataclass
class _Req:
    """Version-normalized request (v1 flagship frame or v2 generic)."""
    version: int
    seq: int
    x0: tuple
    params: tuple
    lh: tuple
    yref: tuple        # () = builder's static references


class RTServer:
    def __init__(self, path: str, N: int = 100, Tf: float = 5.0,
                 ipm_iters: int = 8, batch_window_ms: float = 2.0,
                 max_batch: int = 128, engine: str = "vmap",
                 riccati: str = "lax",
                 centering: str = "fixed", rti_split: bool = False,
                 model: str = "usv_guidance_ca1", mu0=1.0,
                 extra_iters: int = 0, stall_tol: float = None,
                 ipm_tol: float = 1e-7):
        """`engine` selects the fleet compute path:

        - "vmap" (default): per-request batches through the vmapped
          per-instance solver, padded to power-of-two buckets. Latency
          scales with the instantaneous batch size; no fleet-size cap.
        - "lane": the production lane engine (solver/batch.py) with a
          FIXED lane width of `max_batch` — every tick solves all lanes
          in ONE executable (riccati="pallas" runs the Triton sweep
          kernel on a GPU; the production preset's "auto" runs it up to
          its KERNEL_MAX_NX states). Tick cost is flat
          regardless of fleet size; vehicles beyond `max_batch` get
          status=STATUS_OVER_CAPACITY replies until a lane frees up.
          Idle lanes re-solve their last request, which only deepens
          their warm start (RTI iterated at a fixed x0 converges).
        """
        if engine not in ("vmap", "lane"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "vmap" and centering == "adaptive":
            # the per-lane sigma heuristic is lane-engine-only; silently
            # downgrading to fixed would misreport the served schedule
            raise ValueError("adaptive centering requires --engine lane "
                             "(the vmap engine supports fixed/mehrotra)")
        if engine == "vmap" and extra_iters:
            raise ValueError("stall escalation (extra_iters > 0) requires "
                             "--engine lane")
        self.path = path
        # one server instance = one OCP model, mirroring the reference's
        # one-generated-solver-per-node deployment (SURVEY.md §2.1); any
        # zoo model is servable through the v2 frames, the flagship also
        # through the fixed v1 frames
        spec = builders.build(model, Tf=Tf, N=N)
        self.model = model
        self.model_id = protocol.MODEL_IDS[model]
        self.nx = spec.model.nx
        self.nu = spec.model.nu
        self.np_ = spec.model.np_
        self.nh = spec.model.nh
        self.ny = spec.cost.ny
        self._default_yref = np.asarray(spec.cost.yref, np.float32)
        self._yref_e_len = int(np.asarray(spec.cost.yref_e).shape[0])
        self.engine = engine
        # the per-instance engine serves every request on the vmap path:
        # it must run the same schedule the CLI asked for (round-4
        # ADVICE: --centering was silently ignored here)
        self.solver = RTISolver(
            spec, ipm_iters=ipm_iters, ipm_tol=ipm_tol, mu0=mu0,
            centering=centering if centering != "adaptive" else "fixed")
        self.batch_window = batch_window_ms / 1e3
        self.max_batch = max_batch
        self._step1 = jax.jit(self.solver.step_fn)
        self._stepB = jax.jit(jax.vmap(self.solver.step_fn))
        # RTI preparation/feedback split (acados RTI phase schedule,
        # SURVEY.md section 7 hard part 4): after replying to a tick, the
        # solve thread immediately linearizes at the NEW warm start so the
        # next request only pays the QP solve.  Works on BOTH engines:
        # per-vehicle prepared QPs on the vmap path, one fleet-wide
        # prepared LaneQP on the lane path.  Preparation uses the
        # PREVIOUS tick's obstacle table / references (the acados
        # staleness trade-off: fresh x0, one-tick-old params).
        self.rti_split = bool(rti_split)
        if self.rti_split and engine == "vmap":
            self._prepare1 = jax.jit(self.solver.prepare_fn)
            self._feedback1 = jax.jit(self.solver.feedback_fn)
        self._vehicles: Dict[int, _Vehicle] = {}
        self._next_id = 0
        # per-batch device-solve wall time [ms], appended by the solve
        # thread: lets a client-side latency measurement decompose
        # request->reply time into (serving stack overhead) + (device
        # dispatch+solve) (docs/PERF.md).
        # Bounded so a long-lived server doesn't grow without limit.
        import collections
        self.solve_ms = collections.deque(maxlen=4096)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._server: Optional[asyncio.AbstractServer] = None
        # single dedicated solve thread: solves are serialized anyway (one
        # device), and owning it lets warmup() pre-warm exactly this thread
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="nmpc-solve")

        if engine == "lane":
            from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver
            L = max_batch
            self.lane_solver = LaneRTISolver(spec, ipm_iters=ipm_iters,
                                             ipm_tol=ipm_tol,
                                             riccati=riccati,
                                             centering=centering, mu0=mu0,
                                             extra_iters=extra_iters,
                                             stall_tol=stall_tol)
            self._lane_lock = threading.Lock()
            self._lanes_free = list(reversed(range(L)))
            self._lane_of: Dict[int, int] = {}
            # host-side last-request rows (lane-indexed); sentinel obstacle
            # params keep unassigned lanes on benign far-away problems
            self._x0_rows = np.zeros((L, self.nx), np.float32)
            self._p_rows = np.full((L, self.np_), 100.0, np.float32)
            self._lh_rows = np.zeros((L, self.nh), np.float32)
            self._yref_rows = np.broadcast_to(
                self._default_yref, (L, self.ny)).copy()
            self._lane_state = self.lane_solver.init_state(self._x0_rows)

            # one packed upload + one packed fetch per tick: every
            # host<->device transfer is its own copy and sync, so
            # x0/p/lh/yref go up as ONE (L, nx+np+nh+ny) array and
            # u0/x1/status come back as ONE (nu+nx+1, L) array
            NX, NP, NH = self.nx, self.np_, self.nh

            def _tick(state, packed):
                xL = packed[:, :NX].T
                pL = packed[:, NX:NX + NP].T
                lhL = packed[:, NX + NP:NX + NP + NH].T
                yL = packed[:, NX + NP + NH:].T          # (ny, L)
                new_state, outs = self.lane_solver.step_fn(
                    state, xL, pL, lhL, yref=yL,
                    yref_e=yL[:self._yref_e_len])
                out = jnp.concatenate(
                    [outs.u0, outs.x1,
                     outs.status[None].astype(jnp.float32)], axis=0)
                return new_state, out

            self._lane_tick = jax.jit(_tick, donate_argnums=(0,))

            # lane-engine RTI split: ONE fleet-wide prepared LaneQP.  The
            # feedback tick re-pins it at the fresh x0 rows and pays only
            # the IPM; preparation (linearize + assembly) runs right
            # after the replies go out.  A lane join (seed) invalidates
            # the prepared QP — that tick falls back to the full step.
            self._lane_qp = None
            if self.rti_split:
                def _tick_feedback(state, qp, x0_rows):
                    new_state, outs = self.lane_solver.feedback_fn(
                        state, qp, x0_rows.T)
                    out = jnp.concatenate(
                        [outs.u0, outs.x1,
                         outs.status[None].astype(jnp.float32)], axis=0)
                    return new_state, out

                def _tick_prepare(state, packed_pl):
                    pL = packed_pl[:, :NP].T
                    lhL = packed_pl[:, NP:NP + NH].T
                    yL = packed_pl[:, NP + NH:].T
                    return self.lane_solver.prepare_fn(
                        state, pL, lhL, yref=yL,
                        yref_e=yL[:self._yref_e_len])

                self._lane_feedback = jax.jit(_tick_feedback)
                self._lane_prepare = jax.jit(_tick_prepare)

            # single jitted seeder with the lane index as a TRACED scalar:
            # an eager .at[..., lane].set would compile one executable per
            # concrete lane (a compile on every vehicle join, inside the
            # client's 2 s tick-0 budget)
            def _seed(state, x0, lane):
                zero = jnp.int32(0)
                xb = jax.lax.dynamic_update_slice(
                    state.xbar,
                    jnp.broadcast_to(x0[:, None, None],
                                     (x0.shape[0], state.xbar.shape[1], 1)),
                    (zero, zero, lane))
                ub = jax.lax.dynamic_update_slice(
                    state.ubar,
                    jnp.zeros(state.ubar.shape[:-1] + (1,), state.ubar.dtype),
                    (zero, zero, lane))
                return state._replace(xbar=xb, ubar=ub)

            self._lane_seed = jax.jit(_seed, donate_argnums=(0,))

    # ------------------------------------------------------------------
    def warmup(self, all_buckets: bool = False):
        """Compile the single-vehicle and batched paths up front so the
        first real tick meets the latency budget (acados pays this at
        codegen/compile time; we pay it here).  Batched solves are padded
        to power-of-two buckets; `all_buckets=True` pre-compiles every
        bucket up to max_batch (production fleets), the default warms only
        the smallest (dev startup time)."""
        sc_x0 = np.zeros(self.nx, np.float32)
        if self.engine == "lane":
            # lane mode serves every request from the lane table, so only
            # its executables (seed + step) are compiled — the instance
            # engine never runs there.  Compile and dispatch them on the
            # solve thread (the first dispatch from a new thread pays
            # extra overhead), then restore the pristine parked state
            # (donated buffers are consumed)
            def _prewarm_lane():
                st_l = self._lane_seed(
                    self._lane_state, jnp.asarray(sc_x0), jnp.int32(0))
                packed = np.concatenate(
                    [self._x0_rows, self._p_rows, self._lh_rows,
                     self._yref_rows], axis=1)
                st_l, out_l = self._lane_tick(st_l, jnp.asarray(packed))
                # full host fetch, not just a sync: the FIRST device->host
                # transfer also pays one-time setup cost
                np.asarray(out_l)
                if self.rti_split:
                    packed_pl = np.concatenate(
                        [self._p_rows, self._lh_rows, self._yref_rows],
                        axis=1)
                    qp_w = self._lane_prepare(st_l, jnp.asarray(packed_pl))
                    st_l, out_f = self._lane_feedback(
                        st_l, qp_w, jnp.asarray(self._x0_rows))
                    np.asarray(out_f)

            self._executor.submit(_prewarm_lane).result()
            self._lane_state = self.lane_solver.init_state(self._x0_rows)
            return
        st = self.solver.init_state(sc_x0)
        p = jnp.zeros(self.np_, jnp.float32)
        lh = jnp.zeros(self.nh, jnp.float32)
        # argument LIST must mirror _solve_batch exactly: jit's cache key
        # includes the pytree structure, so omitting the trailing
        # yref/yref_e Nones here would compile an executable the serving
        # path never hits (measured: a ~3 s surprise compile on tick 0)
        st, out = self._step1(st, jnp.asarray(sc_x0), p, lh, None, None)
        jax.block_until_ready(out.u0)
        if self.rti_split:
            qp = self._prepare1(st, p, lh)
            _, outf = self._feedback1(st, qp, jnp.asarray(sc_x0))
            jax.block_until_ready(outf.u0)
        buckets = ([1 << k for k in range(1, (self.max_batch - 1)
                                          .bit_length() + 1)]
                   if all_buckets else [2])
        for b in buckets:
            stB = jax.vmap(lambda _: self.solver.init_state(sc_x0))(
                jnp.arange(b))
            xB = jnp.zeros((b, self.nx), jnp.float32)
            # f32 explicitly: under x64 (tests) a bare jnp.zeros is f64 and
            # would warm an executable the f32 serving path never uses
            _, outB = self._stepB(stB, xB,
                                  jnp.zeros((b, self.np_), jnp.float32),
                                  jnp.zeros((b, self.nh), jnp.float32))
            jax.block_until_ready(outB.u0)
        # warm the dispatch path ON THE SOLVE THREAD — the first solve from
        # a worker thread pays extra overhead that must not hit tick 0
        self._executor.submit(self._prewarm).result()

    # ------------------------------------------------------------------
    @staticmethod
    def parse_tcp(path: str):
        """`host:port` or `tcp://host:port` -> (host, port), else None
        (UDS path).  Any spec containing '/' (except the explicit
        `tcp://` scheme) is a filesystem path — a legitimate UDS path
        like `/tmp/nmpc:1` must not be misrouted to getaddrinfo
        (round-4 ADVICE).  The C++ client's addr_is_tcp applies the
        same rule (rt_client/nmpc_rt_client.cpp).

        The TCP listener mirrors the reference's networked node boundary
        (ROS TCPROS topics between processes/machines, reference
        src/nmpc_guidance_ca1.cpp:172-184): a boat computer reaches the
        GPU host over IP with the exact same frame protocol as UDS."""
        if path.startswith("tcp://"):
            path = path[len("tcp://"):]
        elif "/" in path:
            return None
        host, sep, port = path.rpartition(":")
        if sep and host and port.isdigit():
            return host, int(port)
        return None

    async def start(self):
        tcp = self.parse_tcp(self.path)
        if tcp:
            self._server = await asyncio.start_server(
                self._handle_client, host=tcp[0], port=tcp[1])
        else:
            self._server = await asyncio.start_unix_server(
                self._handle_client, path=self.path)
        self._batcher = asyncio.create_task(self._batch_loop())

    @property
    def bound_port(self) -> Optional[int]:
        """Listening TCP port (resolves port 0 requests), None for UDS."""
        if self._server is None or not self.parse_tcp(self.path):
            return None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self):
        self._batcher.cancel()
        self._server.close()
        await self._server.wait_closed()

    # ------------------------------------------------------------------
    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        import socket as socketlib
        import struct

        # TCP transport: disable Nagle — the 20 Hz request/reply frames
        # are far smaller than an MSS and coalescing would add ~40 ms
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family in (socketlib.AF_INET,
                                                socketlib.AF_INET6):
            sock.setsockopt(socketlib.IPPROTO_TCP,
                            socketlib.TCP_NODELAY, 1)

        vid = self._next_id
        self._next_id += 1
        try:
            while True:
                magic_buf = await reader.readexactly(4)
                (magic,) = struct.unpack("<I", magic_buf)
                if magic == protocol.REQ_MAGIC:
                    buf = magic_buf + await reader.readexactly(
                        protocol.REQ_SIZE - 4)
                    r1 = protocol.unpack_request(buf)
                    if self.model != "usv_guidance_ca1":
                        # v1 frames ARE the flagship node's boundary
                        writer.write(protocol.pack_response(
                            protocol.Response(
                                seq=r1.seq,
                                status=protocol.STATUS_BAD_REQUEST,
                                u0=0.0, x1=(0.0,) * protocol.NX)))
                        await writer.drain()
                        continue
                    req = _Req(1, r1.seq, r1.x0, r1.p_obs, r1.r_obs, ())
                elif magic == protocol.REQ2_MAGIC:
                    hdr_buf = magic_buf + await reader.readexactly(
                        protocol.REQ2_HDR_SIZE - 4)
                    hdr = protocol.unpack_request2_header(hdr_buf)
                    seq, mid, nx, np_, nh, ny = hdr
                    payload = await reader.readexactly(
                        4 * (nx + np_ + nh + ny))
                    if (mid != self.model_id or nx != self.nx
                            or np_ != self.np_ or nh != self.nh
                            or ny not in (0, self.ny)):
                        # reply with the server's own dims so the client
                        # can print a useful mismatch message
                        writer.write(protocol.pack_response2(
                            protocol.Response2(
                                seq=seq,
                                status=protocol.STATUS_BAD_REQUEST,
                                u0=(0.0,) * self.nu,
                                x1=(0.0,) * self.nx)))
                        await writer.drain()
                        continue
                    r2 = protocol.unpack_request2_payload(hdr, payload)
                    req = _Req(2, seq, r2.x0, r2.params, r2.lh, r2.yref)
                else:
                    raise ValueError(f"bad request magic 0x{magic:08x}")
                fut = asyncio.get_running_loop().create_future()
                await self._queue.put((vid, req, fut))
                writer.write(await fut)       # fut resolves to wire bytes
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except ValueError as e:
            # malformed frame / bad magic: log before closing so client
            # protocol bugs are diagnosable server-side
            _log.warning("rt client vid=%d protocol error: %s; "
                         "closing connection", vid, e)
        finally:
            self._release_vehicle(vid)
            writer.close()

    # ------------------------------------------------------------------
    async def _batch_loop(self):
        """Collect requests for up to `batch_window`, solve them as one
        batched device call, fan the replies back out."""
        while True:
            vid, req, fut = await self._queue.get()
            batch = [(vid, req, fut)]
            deadline = asyncio.get_running_loop().time() + self.batch_window
            while len(batch) < self.max_batch:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            await asyncio.get_running_loop().run_in_executor(
                self._executor, self._solve_batch, batch)

    # ------------------------------------------------------------------
    def _prewarm(self):
        """Throwaway solve absorbing first-dispatch overhead on the thread
        that will serve requests (run from warmup(); measured ~60 ms that
        would otherwise land inside the first vehicle's tick-0 budget)."""
        zeros = np.zeros(self.nx, np.float32)
        st = self.solver.init_state(zeros)
        _, out = self._step1(st, jnp.asarray(zeros),
                             jnp.zeros(self.np_, jnp.float32),
                             jnp.zeros(self.nh, jnp.float32), None, None)
        jax.block_until_ready(out.u0)

    # ------------------------------------------------------------------
    def _solve_batch(self, batch):
        if self.engine == "lane":
            self._solve_batch_lane(batch)
            return
        for vid, req, _ in batch:
            if vid not in self._vehicles:
                self._vehicles[vid] = _Vehicle(
                    state=self.solver.init_state(
                        np.asarray(req.x0, np.float32)))

        if len(batch) == 1:
            vid, req, fut = batch[0]
            veh = self._vehicles[vid]
            x0 = jnp.asarray(req.x0, jnp.float32)
            p = jnp.asarray(req.params, jnp.float32)
            lh = jnp.asarray(req.lh, jnp.float32)
            yref, yref_e = self._req_yref(req)
            import time as _time
            t_solve = _time.perf_counter()
            if self.rti_split and veh.prepared_qp is not None:
                # FEEDBACK phase: solve the prepared QP at the fresh x0
                new_state, out = self._feedback1(veh.state, veh.prepared_qp,
                                                 x0)
            else:
                new_state, out = self._step1(veh.state, x0, p, lh,
                                             yref, yref_e)
            veh.state = new_state
            u0 = np.asarray(out.u0)       # sync: device solve done here
            self.solve_ms.append((_time.perf_counter() - t_solve) * 1e3)
            self._reply(fut, req, out.status, u0, out.x1)
            if self.rti_split:
                # PREPARATION phase for the next tick, after the reply is
                # already on the wire (this is the latency win)
                veh.prepared_qp = self._prepare1(veh.state, p, lh,
                                                 yref, yref_e)
            return

        # pad to the next power-of-two bucket: jit caches one executable
        # per shape, so buckets bound the number of compiles to
        # log2(max_batch) instead of max_batch (a fresh fleet size would
        # otherwise stall its first tick on a full XLA compile)
        n = len(batch)
        bucket = 1 << (n - 1).bit_length()
        pad = bucket - n
        veh_states = [self._vehicles[vid].state for vid, _, _ in batch]
        veh_states += [veh_states[0]] * pad
        states = jax.tree.map(lambda *xs: jnp.stack(xs), *veh_states)
        row0 = batch[0][1]
        x0 = jnp.asarray([r.x0 for _, r, _ in batch]
                         + [row0.x0] * pad, jnp.float32)
        p = jnp.asarray([r.params for _, r, _ in batch]
                        + [row0.params] * pad, jnp.float32)
        lh = jnp.asarray([r.lh for _, r, _ in batch]
                         + [row0.lh] * pad, jnp.float32)
        import time as _time
        t_solve = _time.perf_counter()
        if any(len(r.yref) for _, r, _ in batch):
            # mixed presence: absentees get the builder's static yref so
            # the batch stays one executable per bucket size
            rows = [(r.yref if len(r.yref) else tuple(self._default_yref))
                    for _, r, _ in batch]
            rows += [rows[0]] * pad
            yrefB = jnp.tile(jnp.asarray(rows, jnp.float32)[:, None, :],
                             (1, self.solver.spec.N, 1))
            yref_eB = jnp.asarray(rows, jnp.float32)[:, :self._yref_e_len]
            new_states, outs = self._stepB(states, x0, p, lh,
                                           yrefB, yref_eB)
        else:
            new_states, outs = self._stepB(states, x0, p, lh)
        np.asarray(outs.u0)               # sync: device solve done here
        self.solve_ms.append((_time.perf_counter() - t_solve) * 1e3)
        for i, (vid, req, fut) in enumerate(batch):
            veh = self._vehicles[vid]
            veh.state = jax.tree.map(lambda a, idx=i: a[idx], new_states)
            # a batched tick advanced this vehicle's warm start, so any QP
            # prepared before it (linearized at the pre-batch state) is
            # stale — drop it; the next solo tick takes the full-step path
            veh.prepared_qp = None
            self._reply(fut, req, outs.status[i], outs.u0[i], outs.x1[i])

    def _solve_batch_lane(self, batch):
        """One fixed-width lane-engine tick serving every queued request.

        All `max_batch` lanes solve every tick (flat cost, one executable);
        requests update their lane's x0/params rows first, replies read
        their lane's column of the outputs."""
        live = []
        seeded = False
        # the lock covers lane assignment AND the host row arrays — the
        # event-loop thread parks freed lanes' rows in _release_vehicle
        # under the same lock, so the device snapshot below cannot tear
        with self._lane_lock:
            for vid, req, fut in batch:
                lane = self._lane_of.get(vid)
                if lane is None:
                    if not self._lanes_free:
                        self._reply(fut, req, STATUS_OVER_CAPACITY,
                                    np.zeros(self.nu, np.float32),
                                    np.zeros(self.nx, np.float32))
                        continue
                    lane = self._lanes_free.pop()
                    self._lane_of[vid] = lane
                    # cold lane: seed the warm start from this x0; the
                    # prepared QP was linearized at the PRE-seed state, so
                    # it no longer matches — this tick runs the full step
                    self._lane_state = self._lane_seed(
                        self._lane_state,
                        jnp.asarray(req.x0, jnp.float32),
                        jnp.int32(lane))
                    seeded = True
                self._x0_rows[lane] = req.x0
                self._p_rows[lane] = req.params
                self._lh_rows[lane] = req.lh
                self._yref_rows[lane] = (req.yref if len(req.yref)
                                         else self._default_yref)
                live.append((lane, req, fut))
            if not live:
                return
            use_split = (self.rti_split and self._lane_qp is not None
                         and not seeded)
            if use_split:
                x0_rows = jnp.asarray(self._x0_rows.copy())
            else:
                packed = jnp.asarray(np.concatenate(
                    [self._x0_rows, self._p_rows, self._lh_rows,
                     self._yref_rows], axis=1))

        import time as _time
        t_solve = _time.perf_counter()
        if use_split:
            # feedback phase only: the QP was prepared right after the
            # previous tick's replies (one-tick-old params/yref, fresh x0)
            new_state, out = self._lane_feedback(
                self._lane_state, self._lane_qp, x0_rows)
        else:
            new_state, out = self._lane_tick(self._lane_state, packed)
        self._lane_state = new_state
        self._lane_qp = None
        out = np.asarray(out)             # ONE fetch: (nu + nx + 1, L)
        self.solve_ms.append((_time.perf_counter() - t_solve) * 1e3)
        nu = out.shape[0] - self.nx - 1
        u0 = out[:nu]
        x1 = out[nu:nu + self.nx]
        status = out[-1].astype(np.int32)
        for lane, req, fut in live:
            self._reply(fut, req, status[lane], u0[:, lane], x1[:, lane])

        if self.rti_split:
            # preparation phase for the NEXT tick: linearize + assemble at
            # the fresh warm start while no request is waiting
            with self._lane_lock:
                packed_pl = np.concatenate(
                    [self._p_rows, self._lh_rows, self._yref_rows], axis=1)
            self._lane_qp = self._lane_prepare(self._lane_state,
                                               jnp.asarray(packed_pl))

    def _req_yref(self, req):
        """Per-request stage references -> solver args (None = builder's)."""
        if not len(req.yref):
            return None, None
        yref = jnp.tile(jnp.asarray(req.yref, jnp.float32)[None, :],
                        (self.solver.spec.N, 1))
        yref_e = jnp.asarray(req.yref[:self._yref_e_len], jnp.float32)
        return yref, yref_e

    def _release_vehicle(self, vid):
        self._vehicles.pop(vid, None)
        if self.engine == "lane":
            with self._lane_lock:
                lane = self._lane_of.pop(vid, None)
                if lane is not None:
                    self._lanes_free.append(lane)
                    # park the freed lane on the benign sentinel problem
                    self._x0_rows[lane] = 0.0
                    self._p_rows[lane] = 100.0
                    self._lh_rows[lane] = 0.0
                    self._yref_rows[lane] = self._default_yref

    @staticmethod
    def _reply(fut, req, status, u0, x1):
        """Resolve `fut` with the WIRE BYTES in the request's own protocol
        version (v1 replies carry the scalar first input, the flagship
        node's command convention; v2 replies carry the full u0 vector)."""
        u0 = np.asarray(u0, np.float32).reshape(-1)
        x1 = np.asarray(x1, np.float32).reshape(-1)
        if req.version == 1:
            buf = protocol.pack_response(protocol.Response(
                seq=req.seq, status=int(status),
                u0=float(u0[0]), x1=tuple(x1)))
        else:
            buf = protocol.pack_response2(protocol.Response2(
                seq=req.seq, status=int(status),
                u0=tuple(u0), x1=tuple(x1)))
        fut.get_loop().call_soon_threadsafe(fut.set_result, buf)


def resolve_engine_args(engine=None, riccati=None,
                        centering=None, ipm_iters=None, extra_iters=None,
                        mu0=None, stall_tol=None, ipm_tol=None,
                        platform=None):
    """Resolve unset server CLI engine flags to the single production
    preset (config.production_engine()) — the same engine bench.py and
    `cli run/mission` default to (round-4 VERDICT: three surfaces had
    three defaults).  Explicit values pass through untouched.
    tests/test_production_preset.py pins the three-surface agreement."""
    from mpc_collisionavoidance_tpu.config import production_engine
    preset = production_engine(platform)
    engine = engine if engine is not None else preset.engine
    return {
        "engine": engine,
        "riccati": riccati if riccati is not None else preset.riccati,
        # the vmap engine (explicit --engine vmap) is the CPU/dev
        # fallback: adaptive centering is lane-only, so its unset
        # centering default is "fixed", not the preset's
        "centering": (centering if centering is not None
                      else (preset.centering if engine == "lane"
                            else "fixed")),
        "ipm_iters": (ipm_iters if ipm_iters is not None
                      else preset.ipm_iters),
        "extra_iters": (extra_iters if extra_iters is not None
                        else (preset.extra_iters if engine == "lane"
                              else 0)),
        "mu0": (preset.mu0 if mu0 is None
                else mu0 if mu0 == "auto" else float(mu0)),
        "stall_tol": (stall_tol if stall_tol is not None
                      else preset.stall_tol),
        "ipm_tol": ipm_tol if ipm_tol is not None else preset.ipm_tol,
    }


async def _amain(path: str, warm_all: bool = False, stop_event=None, **kw):
    server = RTServer(path, **kw)
    server.warmup(all_buckets=warm_all)
    await server.start()
    print(f"rt server listening on {path}", flush=True)
    if stop_event is None:
        await asyncio.Event().wait()          # serve until killed
    else:
        await asyncio.get_running_loop().run_in_executor(
            None, stop_event.wait)
        await server.stop()
        server._executor.shutdown()


def main(argv=None, stop_event: Optional[threading.Event] = None):
    """Server CLI.  `stop_event` (embedding only, e.g. a server on a thread
    of a test or smoke process): serve until it is set, then shut down."""
    import argparse
    parser = argparse.ArgumentParser(description="NMPC real-time server")
    parser.add_argument("socket", nargs="?", default="/tmp/nmpc_rt.sock",
                        help="UDS path, or host:port for a TCP listener "
                             "(cross-machine deployment; same frames)")
    parser.add_argument("--platform", default=None,
                        help="jax platform to pin (cpu/gpu), through "
                             "jax_default_device: the production preset "
                             "follows it")
    parser.add_argument("--model", default="usv_guidance_ca1",
                        choices=sorted(protocol.MODEL_IDS),
                        help="OCP model this server instance solves (one "
                             "server = one model, like one generated "
                             "acados solver per reference node); "
                             "non-flagship models are reachable through "
                             "the v2 wire frames")
    parser.add_argument("-N", type=int, default=None,
                        help="horizon stages (default: the model builder's "
                             "own reference value, e.g. usv_pf's Tf=1/N=100 "
                             "rather than the flagship's Tf=5)")
    parser.add_argument("--tf", type=float, default=None,
                        help="horizon length in seconds (default: the "
                             "model builder's reference value)")
    # engine flags default to None = the ONE production preset
    # (config.production_engine(): lane engine, the Triton Riccati kernel
    # on a GPU / the lax sweep on the CPU, adaptive centering + stall
    # escalation — the same engine bench.py and `cli run/mission` use).
    # Explicit flags override individual fields.
    parser.add_argument("--ipm-iters", type=int, default=None)
    parser.add_argument("--warm-all", action="store_true",
                        help="pre-compile every power-of-two batch bucket "
                             "up to max_batch at startup (production "
                             "fleets; dev default warms only bucket 2)")
    parser.add_argument("--engine", default=None,
                        choices=("vmap", "lane"),
                        help="fleet compute path: lane (fixed-width lane "
                             "engine, flat tick cost — the production "
                             "default) or vmap (elastic batches, the "
                             "CPU/dev fallback)")
    parser.add_argument("--riccati", default=None,
                        choices=RICCATI_BACKENDS,
                        help="lane-engine Riccati sweep (default: the "
                             "production preset's: auto on a GPU = the "
                             "Triton kernel up to its KERNEL_MAX_NX "
                             "states, lax above; lax on the CPU)")
    parser.add_argument("--centering", default=None,
                        choices=("fixed", "adaptive", "mehrotra"),
                        help="IPM centering schedule (default: the "
                             "production preset's adaptive per-lane "
                             "sigma; docs/PERF.md)")
    parser.add_argument("--extra-iters", type=int, default=None,
                        help="stall-escalation budget: extra IPM "
                             "iterations run only while some lane's gap "
                             "is above tolerance (lane engine; the "
                             "production preset's mission-length "
                             "insurance, docs/PERF.md)")
    parser.add_argument("--ipm-tol", type=float, default=None,
                        help="convergence tolerance (status-0 gate; "
                             "default: the production preset's 3e-6)")
    parser.add_argument("--stall-tol", type=float, default=None,
                        help="escalation gate: extra iterations run only "
                             "while some lane's duality gap exceeds this "
                             "(default: the production preset's 3e-6)")
    parser.add_argument("--mu0", default=None,
                        help="initial barrier weight: a float or 'auto' "
                             "(per-lane gradient-scaled; pair with "
                             "--centering mehrotra for 1e5-scale weights "
                             "like usv_position_control)")
    parser.add_argument("--max-batch", type=int, default=128)
    parser.add_argument("--rti-split", action="store_true",
                        help="acados-style RTI preparation/feedback split: "
                             "linearize for the next tick right after "
                             "replying, so a request only pays the QP "
                             "solve (both engines: per-vehicle QPs on "
                             "vmap, one fleet-wide LaneQP on lane)")
    args = parser.parse_args(argv)
    if args.platform:
        jax.config.update("jax_default_device",
                          jax.devices(args.platform)[0])
    eng = resolve_engine_args(args.engine, args.riccati,
                              args.centering, args.ipm_iters,
                              args.extra_iters, args.mu0,
                              stall_tol=args.stall_tol,
                              ipm_tol=args.ipm_tol,
                              platform=args.platform)
    # unset -N/--tf resolve to the served model's own reference (Tf, N)
    # (builders encode SURVEY.md 2.4 per variant), matching cli run —
    # serving usv_pf at the flagship's Tf=5 would be silently wrong
    N, Tf = args.N, args.tf
    if N is None or Tf is None:
        import inspect
        sig = inspect.signature(builders.BUILDERS[args.model])
        if N is None:
            N = sig.parameters["N"].default
        if Tf is None:
            Tf = sig.parameters["Tf"].default
    enable_compile_cache()
    asyncio.run(_amain(args.socket, warm_all=args.warm_all,
                       stop_event=stop_event, N=N, Tf=Tf,
                       max_batch=args.max_batch, rti_split=args.rti_split,
                       model=args.model, **eng))


if __name__ == "__main__":
    main()
