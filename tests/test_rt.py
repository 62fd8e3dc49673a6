"""Real-time serving boundary: protocol, server, and the native C++ client.

The end-to-end test builds the actual C++ client with cmake/g++ and drives
a closed loop through the real UDS socket — the in-process equivalent of
the reference's multi-process ROS smoke setup (SURVEY.md section 4.2).
"""

import asyncio
import math
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mpc_collisionavoidance_tpu.rt import protocol

REPO = Path(__file__).resolve().parent.parent


def test_protocol_roundtrip():
    req = protocol.Request(seq=7, x0=tuple(float(i) for i in range(8)),
                           p_obs=tuple(float(i) for i in range(16)),
                           r_obs=tuple(float(i) for i in range(8)))
    buf = protocol.pack_request(req)
    assert len(buf) == protocol.REQ_SIZE == 136
    back = protocol.unpack_request(buf)
    assert back.seq == 7 and back.x0[3] == 3.0 and back.r_obs[-1] == 7.0

    resp = protocol.Response(seq=9, status=1, u0=0.25,
                             x1=tuple(float(i) for i in range(8)))
    buf = protocol.pack_response(resp)
    assert len(buf) == protocol.RESP_SIZE == 48
    back = protocol.unpack_response(buf)
    assert back.seq == 9 and back.status == 1 and back.u0 == 0.25


def test_protocol_rejects_bad_magic():
    with pytest.raises(ValueError):
        protocol.unpack_request(b"\x00" * protocol.REQ_SIZE)


# ---------------------------------------------------------------------------

class _ServerThread:
    """Run the asyncio RT server on a background thread for tests."""

    def __init__(self, sock_path, **kw):
        from mpc_collisionavoidance_tpu.rt.server import RTServer
        self.server = RTServer(str(sock_path), **kw)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self.server.start())
        self._loop.run_forever()

    @property
    def address(self) -> str:
        port = self.server.bound_port
        if port is not None:
            host = self.server.parse_tcp(self.server.path)[0]
            return f"{host}:{port}"
        return self.server.path

    def __enter__(self):
        self.server.warmup()
        self._thread.start()
        deadline = time.time() + 10
        if self.server.parse_tcp(self.server.path):
            while self.server.bound_port is None:
                assert time.time() < deadline, "TCP listener never bound"
                time.sleep(0.05)
        else:
            while not Path(self.server.path).exists():
                assert time.time() < deadline, "server socket never appeared"
                time.sleep(0.05)
        return self

    def __exit__(self, *exc):
        async def _stop():
            await self.server.stop()
        asyncio.run_coroutine_threadsafe(_stop(), self._loop).result(5)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(5)


def _python_client_solve(sock_path, req):
    import socket as socketlib
    s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    s.connect(str(sock_path))
    s.sendall(protocol.pack_request(req))
    buf = b""
    while len(buf) < protocol.RESP_SIZE:
        buf += s.recv(protocol.RESP_SIZE - len(buf))
    s.close()
    return protocol.unpack_response(buf)


def test_server_python_client(tmp_path):
    """Python-side client solves the flagship scenario one tick."""
    sock = tmp_path / "nmpc.sock"
    with _ServerThread(sock, N=20, Tf=1.0, ipm_iters=6):
        ak = math.pi / 2
        p = [100.0] * 16
        r = [0.0] * 8
        req = protocol.Request(
            seq=3, x0=(0.7, 0.0, -4.0, -ak, -ak, 0.0, 0.0, 0.0),
            p_obs=tuple(p), r_obs=tuple(r))
        resp = _python_client_solve(sock, req)
        assert resp.seq == 3
        assert resp.status in (0, 1)
        assert np.isfinite(resp.u0)
        # with ye = -4 the controller must steer toward the path
        assert abs(resp.u0) > 1e-4


@pytest.mark.skipif(shutil.which("cmake") is None or shutil.which("g++") is None,
                    reason="native toolchain unavailable")
@pytest.mark.slow
def test_cpp_client_closed_loop(tmp_path):
    """Build the real C++ client + demo and run 60 closed-loop ticks
    against the live server; the demo exits 0 iff every solve succeeded
    and the vehicle converged to the path."""
    build = tmp_path / "build"
    subprocess.run(["cmake", "-S", str(REPO / "rt_client"), "-B", str(build),
                    "-DCMAKE_BUILD_TYPE=Release"], check=True,
                   capture_output=True)
    subprocess.run(["cmake", "--build", str(build), "-j4"], check=True,
                   capture_output=True)

    sock = tmp_path / "nmpc.sock"
    # flagship RT configuration (N=100, Tf=5): shorter horizons stall
    # against the on-path buoys (2 s of lookahead cannot see past them)
    with _ServerThread(sock, N=100, Tf=5.0, ipm_iters=8):
        # 1000 ticks = the reference's full Nsim at dt = 0.05 s
        out = subprocess.run([str(build / "rt_demo"), str(sock), "1000"],
                             capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "worst_latency_us" in out.stdout
    # vehicle converged (demo already asserts |ye| < 0.5; sanity-check log)
    final_ye = float(out.stdout.rsplit("final_ye", 1)[1])
    assert abs(final_ye) < 0.5


def test_server_bucket_padding(tmp_path):
    """Three concurrent vehicles land in one padded power-of-two batch
    (bucket 4) and each gets its own correct reply; a lone follow-up from
    each vehicle then reuses its warm-started state (seq echoes back)."""
    sock = tmp_path / "nmpc.sock"
    with _ServerThread(sock, N=20, Tf=1.0, ipm_iters=6,
                       batch_window_ms=50.0) as srv:
        ak = math.pi / 2
        yes = (-4.0, -2.0, 3.0)

        def solve_one(i):
            req = protocol.Request(
                seq=100 + i, x0=(0.7, 0.0, yes[i], -ak, -ak, 0.0, 0.0, 0.0),
                p_obs=tuple([100.0] * 16), r_obs=tuple([0.0] * 8))
            return _python_client_solve(sock, req)

        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(3) as ex:
            resps = list(ex.map(solve_one, range(3)))
        for i, resp in enumerate(resps):
            assert resp.seq == 100 + i
            assert resp.status in (0, 1)
            assert np.isfinite(resp.u0)
        # each vehicle's reply carries ITS OWN predicted state (padding must
        # not mix rows): the stage-1 cross-track errors track the requests
        # (u0 is legitimately near-identical on a cold tick — the chi_e
        # error saturates the first RTI response regardless of ye)
        x1_ye = [r.x1[2] for r in resps]
        for i in range(3):
            assert abs(x1_ye[i] - yes[i]) < 0.5, (i, x1_ye[i])
        # only power-of-two executables were compiled for the batched path
        assert srv.server._stepB._cache_size() <= 2


def test_server_lane_engine(tmp_path):
    """Lane-engine serving mode: fixed 4-lane width, three vehicles share
    one flat-cost tick; a fourth is rejected with the over-capacity status
    while all lanes are held, and a freed lane is reusable."""
    from mpc_collisionavoidance_tpu.rt.server import STATUS_OVER_CAPACITY

    sock = tmp_path / "nmpc.sock"
    with _ServerThread(sock, N=20, Tf=1.0, ipm_iters=6, engine="lane",
                       max_batch=4, batch_window_ms=50.0):
        import socket as socketlib

        ak = math.pi / 2
        yes = (-4.0, -2.0, 3.0, 1.0)

        def connect_and_solve(i, sock_obj=None):
            s = sock_obj or socketlib.socket(socketlib.AF_UNIX,
                                             socketlib.SOCK_STREAM)
            if sock_obj is None:
                s.connect(str(sock))
            req = protocol.Request(
                seq=200 + i, x0=(0.7, 0.0, yes[i], -ak, -ak, 0.0, 0.0, 0.0),
                p_obs=tuple([100.0] * 16), r_obs=tuple([0.0] * 8))
            s.sendall(protocol.pack_request(req))
            buf = b""
            while len(buf) < protocol.RESP_SIZE:
                buf += s.recv(protocol.RESP_SIZE - len(buf))
            return s, protocol.unpack_response(buf)

        # hold 4 persistent connections -> all 4 lanes taken
        socks = []
        for i in range(4):
            s, resp = connect_and_solve(i)
            socks.append(s)
            assert resp.seq == 200 + i
            assert resp.status in (0, 1)
            assert abs(resp.x1[2] - yes[i]) < 0.5   # own trajectory echoed
        # 5th vehicle: over capacity
        s5, resp5 = connect_and_solve(0)
        assert resp5.status == STATUS_OVER_CAPACITY
        s5.close()
        # repeated tick on a held connection reuses the warm lane
        _, again = connect_and_solve(0, sock_obj=socks[0])
        assert again.status in (0, 1)
        # free one lane, a new vehicle can join
        socks[3].close()
        time.sleep(0.3)
        s6, resp6 = connect_and_solve(1)
        assert resp6.status in (0, 1)
        s6.close()
        for s in socks[:3]:
            s.close()


def test_server_rti_split(tmp_path):
    """--rti-split serving: with constant obstacle params the
    prepare+feedback schedule must produce EXACTLY the same replies as the
    fused single-phase server (the split is exact when params are
    unchanged between preparation and feedback; test_sqp_rti proves the
    solver-level identity, this proves the serving plumbing)."""
    import socket as socketlib

    ak = math.pi / 2
    p = tuple([100.0] * 16)
    r = tuple([0.0] * 8)

    def run_ticks(sock_path, n):
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.connect(str(sock_path))
        x0 = (0.7, 0.0, -4.0, -ak, -ak, 0.0, 0.0, 0.0)
        out = []
        for k in range(n):
            req = protocol.Request(seq=k, x0=x0, p_obs=p, r_obs=r)
            s.sendall(protocol.pack_request(req))
            buf = b""
            while len(buf) < protocol.RESP_SIZE:
                buf += s.recv(protocol.RESP_SIZE - len(buf))
            resp = protocol.unpack_response(buf)
            assert resp.seq == k
            out.append((resp.u0, resp.x1, resp.status))
            x0 = resp.x1                      # closed loop via the wire
        s.close()
        return out

    sock_a = tmp_path / "a.sock"
    with _ServerThread(sock_a, N=20, Tf=1.0, ipm_iters=6):
        ref = run_ticks(sock_a, 5)
    sock_b = tmp_path / "b.sock"
    with _ServerThread(sock_b, N=20, Tf=1.0, ipm_iters=6, rti_split=True):
        split = run_ticks(sock_b, 5)

    for (u_a, x_a, st_a), (u_b, x_b, st_b) in zip(ref, split):
        assert st_b in (0, 1)
        np.testing.assert_allclose(u_b, u_a, rtol=0, atol=1e-6)
        np.testing.assert_allclose(x_b, x_a, rtol=0, atol=1e-6)


@pytest.mark.slow
def test_server_rti_split_mixed_batched_solo(tmp_path):
    """Regression: a batched tick (two vehicles in one window) advances the
    warm starts through _stepB, so any QP prepared before it is linearized
    at a stale state; the NEXT solo tick must take the full-step path, not
    feed the stale QP into feedback.  The solo/batched/solo sequence must
    reproduce the non-split server exactly."""
    import socket as socketlib

    ak = math.pi / 2
    p = tuple([100.0] * 16)
    r = tuple([0.0] * 8)

    def connect(sock_path):
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.connect(str(sock_path))
        return s

    def send(s, seq, x0):
        s.sendall(protocol.pack_request(
            protocol.Request(seq=seq, x0=tuple(x0), p_obs=p, r_obs=r)))

    def recv(s):
        buf = b""
        while len(buf) < protocol.RESP_SIZE:
            buf += s.recv(protocol.RESP_SIZE - len(buf))
        return protocol.unpack_response(buf)

    x0a = (0.7, 0.0, -4.0, -ak, -ak, 0.0, 0.0, 0.0)
    x0b = (0.7, 0.0, 3.0, -ak, -ak, 0.0, 0.0, 0.0)

    def run_sequence(sock_path):
        sa, sb = connect(sock_path), connect(sock_path)
        out = []
        # tick 1: A solo (the split server prepares A's next QP after this)
        send(sa, 0, x0a)
        ra = recv(sa)
        out.append(ra)
        # tick 2: A and B land in ONE batch window -> batched _stepB path
        send(sa, 1, ra.x1)
        send(sb, 2, x0b)
        ra2, rb = recv(sa), recv(sb)
        out += [ra2, rb]
        # tick 3: A solo again, from the post-batch state
        send(sa, 3, ra2.x1)
        out.append(recv(sa))
        sa.close()
        sb.close()
        return out

    kw = dict(N=20, Tf=1.0, ipm_iters=6, batch_window_ms=100.0)
    with _ServerThread(tmp_path / "a.sock", **kw) as srv_a:
        ref = run_sequence(srv_a.server.path)
    with _ServerThread(tmp_path / "b.sock", rti_split=True, **kw) as srv_b:
        split = run_sequence(srv_b.server.path)

    for r_ref, r_spl in zip(ref, split):
        assert r_spl.seq == r_ref.seq
        assert r_spl.status in (0, 1)
        np.testing.assert_allclose(r_spl.u0, r_ref.u0, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r_spl.x1, r_ref.x1, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# protocol v2: variant-generic serving

def test_protocol2_roundtrip():
    req = protocol.Request2(seq=5, model_id=protocol.MODEL_IDS["usv_pf"],
                            x0=tuple(float(i) for i in range(14)),
                            params=(), lh=(),
                            yref=tuple(float(i) for i in range(16)))
    buf = protocol.pack_request2(req)
    hdr = protocol.unpack_request2_header(buf[:protocol.REQ2_HDR_SIZE])
    back = protocol.unpack_request2_payload(hdr,
                                            buf[protocol.REQ2_HDR_SIZE:])
    assert back.seq == 5 and back.model_id == req.model_id
    assert back.x0[13] == 13.0 and back.yref[15] == 15.0
    assert back.params == () and back.lh == ()

    resp = protocol.Response2(seq=9, status=0, u0=(0.5, -0.5),
                              x1=tuple(float(i) for i in range(14)))
    buf = protocol.pack_response2(resp)
    back = protocol.unpack_response2(buf[:protocol.RESP2_HDR_SIZE],
                                     buf[protocol.RESP2_HDR_SIZE:])
    assert back.u0 == (0.5, -0.5) and back.x1[13] == 13.0


class _V2Client:
    """Persistent-connection python client speaking protocol v2."""

    def __init__(self, sock_path):
        import socket as socketlib
        self.s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        self.s.connect(str(sock_path))

    def solve(self, model, seq, x0, params=(), lh=(), yref=()):
        req = protocol.Request2(seq=seq,
                                model_id=protocol.MODEL_IDS[model],
                                x0=tuple(x0), params=tuple(params),
                                lh=tuple(lh), yref=tuple(yref))
        self.s.sendall(protocol.pack_request2(req))
        hdr = self._read(protocol.RESP2_HDR_SIZE)
        import struct
        _, _, _, nu, nx = struct.unpack(protocol.RESP2_HDR_FMT, hdr)
        payload = self._read(4 * (nu + nx))
        return protocol.unpack_response2(hdr, payload)

    def _read(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.s.recv(n - len(buf))
            assert chunk, "server closed connection"
            buf += chunk
        return buf

    def close(self):
        self.s.close()


@pytest.mark.slow
def test_server_v2_pf_closed_loop(tmp_path):
    """`rt.server --model usv_pf` driven through v2 frames with a wire
    yref (head along the segment at u_d = 0.7): the full 14-state hull
    converges toward the commanded surge over the wire."""
    import numpy as np_

    sock = tmp_path / "pf.sock"
    with _ServerThread(sock, model="usv_pf", N=30, Tf=0.3, ipm_iters=8):
        ak = math.pi / 2
        ye0 = 4.0
        x0 = [0.0, 0.0, 1.0, 0.001, 0.0, 0.0, ye0,
              4.0, -5.0, ak, 0.0, 0.0, 0.0, 0.0]
        yref = [0.0] * 16
        yref[1], yref[2], yref[3] = math.sin(ak), math.cos(ak), 0.7
        cli = _V2Client(sock)
        try:
            for k in range(60):
                resp = cli.solve("usv_pf", k, x0, yref=yref)
                assert resp.seq == k
                assert resp.status in (0, 1)
                assert len(resp.u0) == 2 and len(resp.x1) == 14
                assert np_.all(np_.isfinite(resp.x1))
                x0 = resp.x1
        finally:
            cli.close()
        # surge climbed toward the wire-commanded 0.7 m/s (the wire loop is
        # bit-exact with the direct RTISolver run: both reach 0.2891 at
        # tick 60 — the weighted NMPC accelerates gently)
        assert resp.x1[3] > 0.25, resp.x1


def test_server_v2_rejects_mismatched_dims_and_v1(tmp_path):
    """A pf server answers BAD_REQUEST to (a) v2 frames with wrong dims /
    model id and (b) flagship v1 frames — and keeps serving afterwards."""
    sock = tmp_path / "pf.sock"
    with _ServerThread(sock, model="usv_pf", N=20, Tf=0.2, ipm_iters=6):
        cli = _V2Client(sock)
        try:
            # wrong model id for these dims
            resp = cli.solve("usv_guidance_ca1", 0, [0.0] * 8)
            assert resp.status == protocol.STATUS_BAD_REQUEST
            # right model, wrong nx
            resp = cli.solve("usv_pf", 1, [0.0] * 8)
            assert resp.status == protocol.STATUS_BAD_REQUEST
            # recovery: a correct frame still solves
            x0 = [0.0, 0.0, 1.0, 0.001, 0.0, 0.0, 0.0,
                  4.0, -5.0, math.pi / 2, 0.0, 0.0, 0.0, 0.0]
            resp = cli.solve("usv_pf", 2, x0)
            assert resp.status in (0, 1)
        finally:
            cli.close()

        # v1 frames are the flagship boundary: rejected on a pf server
        ak = math.pi / 2
        req = protocol.Request(
            seq=7, x0=(0.7, 0.0, -4.0, -ak, -ak, 0.0, 0.0, 0.0),
            p_obs=tuple([100.0] * 16), r_obs=tuple([0.0] * 8))
        resp = _python_client_solve(sock, req)
        assert resp.status == protocol.STATUS_BAD_REQUEST


@pytest.mark.skipif(shutil.which("cmake") is None or shutil.which("g++") is None,
                    reason="native toolchain unavailable")
@pytest.mark.slow
def test_cpp_client_v2_low_level(tmp_path):
    """Build and run the v2 C++ demo: the inner-loop thrust node served
    generically (runtime dims + wire yref), closed loop to the commanded
    psi_d = 1.0 rad / u_d = 0.8 m/s."""
    build = tmp_path / "build"
    subprocess.run(["cmake", "-S", str(REPO / "rt_client"), "-B", str(build),
                    "-DCMAKE_BUILD_TYPE=Release"], check=True,
                   capture_output=True)
    subprocess.run(["cmake", "--build", str(build), "-j4"], check=True,
                   capture_output=True)

    sock = tmp_path / "ll.sock"
    with _ServerThread(sock, model="usv_low_level", N=100, Tf=1.0,
                       ipm_iters=8):
        out = subprocess.run([str(build / "rt_demo2"), str(sock), "400"],
                             capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "worst_latency_us" in out.stdout
    final_psi = float(out.stdout.rsplit("final_psi", 1)[1].split()[0])
    assert abs(final_psi - 1.0) < 0.1


def test_server_lane_rti_split(tmp_path):
    """Lane-engine --rti-split serving: the prepare+feedback schedule must
    produce exactly the same closed-loop replies as the single-phase lane
    server when params are constant (VERDICT r3 item 4: rti-split works
    with --engine lane)."""
    import socket as socketlib

    ak = math.pi / 2
    p = tuple([100.0] * 16)
    r = tuple([0.0] * 8)

    def run_ticks(sock_path, n):
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.connect(str(sock_path))
        x0 = (0.7, 0.0, -4.0, -ak, -ak, 0.0, 0.0, 0.0)
        out = []
        for k in range(n):
            req = protocol.Request(seq=k, x0=x0, p_obs=p, r_obs=r)
            s.sendall(protocol.pack_request(req))
            buf = b""
            while len(buf) < protocol.RESP_SIZE:
                buf += s.recv(protocol.RESP_SIZE - len(buf))
            resp = protocol.unpack_response(buf)
            assert resp.seq == k
            out.append((resp.u0, resp.x1, resp.status))
            x0 = resp.x1
        s.close()
        return out

    kw = dict(N=20, Tf=1.0, ipm_iters=6, engine="lane", max_batch=4)
    with _ServerThread(tmp_path / "a.sock", **kw):
        ref = run_ticks(tmp_path / "a.sock", 5)
    with _ServerThread(tmp_path / "b.sock", rti_split=True, **kw):
        split = run_ticks(tmp_path / "b.sock", 5)

    for k, ((u_a, x_a, st_a), (u_b, x_b, st_b)) in enumerate(zip(ref, split)):
        assert st_b in (0, 1), (k, st_b)
        np.testing.assert_allclose(u_b, u_a, rtol=0, atol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(x_b, x_a, rtol=0, atol=1e-6, err_msg=str(k))


def test_server_tcp_transport(tmp_path):
    """TCP listener (`host:port` address): the cross-machine deployment
    boundary (the reference's networked TCPROS node graph, reference
    src/nmpc_guidance_ca1.cpp:172-184).  Same v1 frames as UDS; closed
    loop over TCP loopback must match a UDS server tick-for-tick."""
    import socket as socketlib

    ak = math.pi / 2
    p = tuple([100.0] * 16)
    r = tuple([0.0] * 8)

    def run_ticks(conn_fn, n):
        s = conn_fn()
        x0 = (0.7, 0.0, -4.0, -ak, -ak, 0.0, 0.0, 0.0)
        out = []
        for k in range(n):
            req = protocol.Request(seq=k, x0=x0, p_obs=p, r_obs=r)
            s.sendall(protocol.pack_request(req))
            buf = b""
            while len(buf) < protocol.RESP_SIZE:
                chunk = s.recv(protocol.RESP_SIZE - len(buf))
                assert chunk, "server closed connection"
                buf += chunk
            resp = protocol.unpack_response(buf)
            assert resp.seq == k
            out.append((resp.u0, resp.x1, resp.status))
            x0 = resp.x1
        s.close()
        return out

    with _ServerThread("127.0.0.1:0", N=20, Tf=1.0, ipm_iters=6) as st:
        port = st.server.bound_port
        assert port and st.address == f"127.0.0.1:{port}"

        def tcp_conn():
            s = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
            s.connect(("127.0.0.1", port))
            s.setsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY, 1)
            return s

        tcp = run_ticks(tcp_conn, 5)

    sock = tmp_path / "uds.sock"
    with _ServerThread(sock, N=20, Tf=1.0, ipm_iters=6):
        def uds_conn():
            s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
            s.connect(str(sock))
            return s

        uds = run_ticks(uds_conn, 5)

    for (u_t, x_t, st_t), (u_u, x_u, st_u) in zip(tcp, uds):
        assert st_t in (0, 1)
        np.testing.assert_allclose(u_t, u_u, rtol=0, atol=1e-6)
        np.testing.assert_allclose(x_t, x_u, rtol=0, atol=1e-6)


def test_server_cli_entry_serves_until_stop_event():
    """`rt.server.main([...], stop_event=...)` — the `python -m ...rt.server`
    entry, embedded on a thread — serves B=1 and fleet ticks through the
    production preset and shuts down when the event is set (the serving
    phase of chip_smoke.py, at a tiny size on the CPU)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before = {t.name for t in threading.enumerate()}
    smoke.phase_serving(b1_ticks=3, fleet_ticks=2, fleet=2,
                        server_args=("--platform", "cpu", "--max-batch", "4",
                                     "-N", "10", "--tf", "1.0"))
    assert "rt-server" not in {t.name for t in threading.enumerate()} - before
