"""The 13 OCP model variants of the reference, as pure JAX dynamics.

Each builder returns a :class:`~mpc_collisionavoidance_tpu.models.base.Model`
mirroring the information content of the reference's
``scripts/<variant>/usv_model.py`` (states, controls, explicit dynamics,
bounds, nonlinear distance constraints, default x0) — with file:line citations
in each docstring so parity can be checked against the CasADi originals.

Design notes (accelerator-first):
- dynamics are scalar `jnp` expressions over unpacked state components; XLA
  fuses them into a handful of elementwise kernels, and `jax.jacfwd` over the RK4 step
  provides the exact discrete sensitivities the reference obtains from
  CasADi-generated VDE C code;
- obstacle tables enter as flat parameter vectors p = (ox1,oy1,...,ox8,oy8)
  exactly like the acados stage-wise params (reference
  scripts/usv_guidance_ca1/usv_model.py:94-110), so batched scenario sweeps
  can vmap over them.
"""

import numpy as np
import jax.numpy as jnp

from mpc_collisionavoidance_tpu.models import hydro
from mpc_collisionavoidance_tpu.models.base import Model

INF = 1e12  # stand-in for +inf bounds; kept finite for IPM masking logic

_e = np.zeros((0,))


def _obstacle_distances(xp, yp, p, n_obs):
    """Euclidean distances from position (xp, yp) to `n_obs` obstacle centers.

    p holds (ox1, oy1, ox2, oy2, ...) like the acados parameter vector
    (reference scripts/usv_guidance_ca1/usv_model.py:133-140).  Written as an
    unrolled stack of scalar expressions so it is *shape-polymorphic*: the
    components may be scalars (per-instance path) or (N, B) lane tensors
    (batched lane engine) — only broadcasting is used, never reshapes.
    """
    ds = []
    for i in range(n_obs):
        dx = xp - p[2 * i]
        dy = yp - p[2 * i + 1]
        ds.append(jnp.sqrt(dx * dx + dy * dy))
    return jnp.stack(ds)


# ---------------------------------------------------------------------------
# Full hydrodynamic family
# ---------------------------------------------------------------------------

def usv_acados() -> Model:
    """5-state velocity/thrust model (reference scripts/usv_acados/usv_model.py).

    x = (u, v, r, Tport, Tstbd); U = (Tportdot, Tstbddot); c = 0.78.
    Bounds: usv_model.py:129-147; x0: usv_model.py (0.001, 0, 0, 0, 0).
    """
    c = 0.78

    def f(x, u_ctl, p):
        u, v, r, tport, tstbd = x
        tu, tr = hydro.thrust_map(tport, tstbd, c)
        du, dv, dr = hydro.uvr_dot(u, v, r, tu, tr)
        return jnp.stack([du, dv, dr, u_ctl[0], u_ctl[1]])

    return Model(
        name="usv_acados", nx=5, nu=2, np_=0, f=f,
        f_dep=(0, 1, 2, 3, 4, 5, 6),
        x0=np.array([0.001, 0.0, 0.0, 0.0, 0.0]),
        state_names=("u", "v", "r", "Tport", "Tstbd"),
        control_names=("UTportdot", "UTstbddot"),
        lbu=np.array([-30.0, -30.0]), ubu=np.array([30.0, 30.0]),
        idxbu=np.array([0, 1]),
        lbx=np.array([-1.5, -1.5, -1.0, -30.0, -30.0]),
        ubx=np.array([1.5, 1.5, 1.0, 35.0, 35.0]),
        idxbx=np.array([0, 1, 2, 3, 4]),
    )


def usv_low_level() -> Model:
    """8-state inner-loop speed+heading model (reference
    scripts/usv_low_level/usv_model.py).

    x = (psi, sinpsi, cospsi, u, v, r, Tport, Tstbd); the heading enters via
    its embedded (sin, cos) pair with d(sinpsi)=cos(psi)*r, d(cospsi)=-sin(psi)*r;
    Tstbd integrates UTstbddot/c (c = 0.78).
    """
    c = 0.78

    def f(x, u_ctl, p):
        psi, _sinpsi, _cospsi, u, v, r, tport, tstbd = x
        tu, tr = hydro.thrust_map(tport, tstbd, c)
        du, dv, dr = hydro.uvr_dot(u, v, r, tu, tr)
        return jnp.stack([
            r,
            jnp.cos(psi) * r,
            -jnp.sin(psi) * r,
            du, dv, dr,
            u_ctl[0],
            u_ctl[1] / c,
        ])

    return Model(
        name="usv_low_level", nx=8, nu=2, np_=0, f=f,
        f_dep=(0, 3, 4, 5, 6, 7, 8, 9),
        x0=np.array([0.0, 0.0, 1.0, 0.001, 0.0, 0.0, 0.0, 0.0]),
        state_names=("psi", "sinpsi", "cospsi", "u", "v", "r", "Tport", "Tstbd"),
        control_names=("UTportdot", "UTstbddot"),
        lbu=np.array([-30.0, -30.0]), ubu=np.array([30.0, 30.0]),
        idxbu=np.array([0, 1]),
        lbx=np.array([-2.0, -2.0, -10.0, -30.0, -30.0]),
        ubx=np.array([2.0, 2.0, 10.0, 35.0, 35.0]),
        idxbx=np.array([3, 4, 5, 6, 7]),
    )


def usv_position_control() -> Model:
    """8-state NED position control model (reference
    scripts/usv_position_control/usv_model.py).

    x = (x, y, psi, u, v, r, Tport, Tstbd); c = 0.78; both thrusts integrate
    their rates directly (no /c on starboard here, per the reference).
    """
    c = 0.78

    def f(x, u_ctl, p):
        _x, _y, psi, u, v, r, tport, tstbd = x
        tu, tr = hydro.thrust_map(tport, tstbd, c)
        du, dv, dr = hydro.uvr_dot(u, v, r, tu, tr)
        return jnp.stack([
            u * jnp.cos(psi) - v * jnp.sin(psi),
            u * jnp.sin(psi) + v * jnp.cos(psi),
            r,
            du, dv, dr,
            u_ctl[0],
            u_ctl[1],
        ])

    return Model(
        name="usv_position_control", nx=8, nu=2, np_=0, f=f,
        f_dep=(2, 3, 4, 5, 6, 7, 8, 9),
        x0=np.array([0.001] * 8),
        state_names=("x", "y", "psi", "u", "v", "r", "Tport", "Tstbd"),
        control_names=("UTportdot", "UTstbddot"),
        lbu=np.array([-30.0, -30.0]), ubu=np.array([30.0, 30.0]),
        idxbu=np.array([0, 1]),
        lbx=np.array([-1.5, -1.5, -1.0, -30.0, -30.0]),
        ubx=np.array([1.5, 1.5, 1.0, 35.0, 35.0]),
        idxbx=np.array([3, 4, 5, 6, 7]),
    )


def _pf_dynamics(c):
    """Shared 14-state path-following dynamics for usv_pf / usv_pf_ca
    (reference scripts/usv_pf_ca/usv_model.py:137-160).

    x = (psi, sinpsi, cospsi, u, v, r, ye, x1, y1, ak, nedx, nedy, Tport, Tstbd);
    the (sin, cos) embedding rotates with course angle chi = psi + beta and the
    frozen segment params (x1, y1, ak) ride along with zero derivative.
    """

    def f(x, u_ctl, p):
        psi, _s, _c, u, v, r, _ye, _x1, _y1, ak, _nx, _ny, tport, tstbd = x
        tu, tr = hydro.thrust_map(tport, tstbd, c)
        du, dv, dr = hydro.uvr_dot(u, v, r, tu, tr)
        beta = jnp.arctan2(v, u + 0.001)
        chi = psi + beta
        xned_dot = u * jnp.cos(psi) - v * jnp.sin(psi)
        yned_dot = u * jnp.sin(psi) + v * jnp.cos(psi)
        return jnp.stack([
            r,
            jnp.cos(chi) * r,
            -jnp.sin(chi) * r,
            du, dv, dr,
            -xned_dot * jnp.sin(ak) + yned_dot * jnp.cos(ak),
            jnp.zeros_like(psi),
            jnp.zeros_like(psi),
            jnp.zeros_like(psi),
            xned_dot,
            yned_dot,
            u_ctl[0],
            u_ctl[1] / c,
        ])

    return f


_PF_STATE_NAMES = ("psi", "sinpsi", "cospsi", "u", "v", "r", "ye",
                   "x1", "y1", "ak", "nedx", "nedy", "Tport", "Tstbd")
_PF_X0 = np.array([0.0, 0.0, 1.0, 0.001, 0.0, 0.0, 0.0,
                   1.0, -1.0, np.arctan2(3.8 - (-1.0), 1.0 - 1.0), 0.0, 0.0, 0.0, 0.0])


def usv_pf() -> Model:
    """14-state single-layer path-following model (reference
    scripts/usv_pf/usv_model.py; c = 1.0 at :77)."""
    return Model(
        name="usv_pf", nx=14, nu=2, np_=0, f=_pf_dynamics(c=1.0),
        f_dep=(0, 3, 4, 5, 9, 12, 13, 14, 15),
        x0=_PF_X0.copy(),
        state_names=_PF_STATE_NAMES,
        control_names=("UTportdot", "UTstbddot"),
        lbu=np.array([-30.0, -30.0]), ubu=np.array([30.0, 30.0]),
        idxbu=np.array([0, 1]),
        lbx=np.array([-2.0, -2.0, -10.0, -30.0, -30.0]),
        ubx=np.array([2.0, 2.0, 10.0, 36.5, 36.5]),
        idxbx=np.array([3, 4, 5, 12, 13]),
    )


def usv_pf_ca() -> Model:
    """usv_pf + 4 hard obstacle-distance constraints (reference
    scripts/usv_pf_ca/usv_model.py:122-131,165-168,213).

    p = (ox1, oy1, ..., ox4, oy4); h_i = dist((nedx, nedy), obs_i) with
    lh = 0 (runtime-raised to the obstacle radii) and uh = 1e6.
    """

    def h(x, p):
        return _obstacle_distances(x[10], x[11], p, 4)

    return Model(
        name="usv_pf_ca", nx=14, nu=2, np_=8, f=_pf_dynamics(c=1.0),
        f_dep=(0, 3, 4, 5, 9, 12, 13, 14, 15), h_dep=(10, 11),
        x0=_PF_X0.copy(),
        state_names=_PF_STATE_NAMES,
        control_names=("UTportdot", "UTstbddot"),
        lbu=np.array([-30.0, -30.0]), ubu=np.array([30.0, 30.0]),
        idxbu=np.array([0, 1]),
        lbx=np.array([-2.0, -2.0, -10.0, -30.0, -30.0]),
        ubx=np.array([2.0, 2.0, 10.0, 36.5, 36.5]),
        idxbx=np.array([3, 4, 5, 12, 13]),
        h=h, nh=4,
        lh=np.zeros(4), uh=np.full(4, 1e6),
    )


# ---------------------------------------------------------------------------
# Kinematic guidance family
# ---------------------------------------------------------------------------

def usv_guidance() -> Model:
    """10-state guidance v1 with first-order heading response (reference
    scripts/usv_guidance/usv_model.py:60-115; T1 = 1.0)."""
    T1 = 1.0

    def f(x, u_ctl, p):
        _nx, _ny, psi, _s, _c, u, v, _ye, ak, psid = x
        xned_dot = u * jnp.cos(psi) - v * jnp.sin(psi)
        yned_dot = u * jnp.sin(psi) + v * jnp.cos(psi)
        psi_rate = (psid - psi) / T1
        return jnp.stack([
            xned_dot,
            yned_dot,
            psi_rate,
            jnp.cos(psi) * psi_rate,
            -jnp.sin(psi) * psi_rate,
            jnp.zeros_like(psi),
            jnp.zeros_like(psi),
            -xned_dot * jnp.sin(ak) + yned_dot * jnp.cos(ak),
            jnp.zeros_like(psi),
            u_ctl[0],
        ])

    ak0 = np.arctan2(-15.0 - 2.0, 6.0 - 2.0)
    ye0 = -(0.0 - 2.0) * np.sin(ak0) + (0.0 - 2.0) * np.cos(ak0)
    return Model(
        name="usv_guidance", nx=10, nu=1, np_=0, f=f,
        f_dep=(2, 5, 6, 8, 9, 10),
        x0=np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, ye0, ak0, 0.0]),
        state_names=("nedx", "nedy", "psi", "sinpsi", "cospsi", "u", "v",
                     "ye", "ak", "psid"),
        control_names=("Upsiddot",),
        lbu=np.array([-1.5]), ubu=np.array([1.5]), idxbu=np.array([0]),
        lbx=np.array([-2.0, -2.0, -np.pi]),
        ubx=np.array([2.0, 2.0, np.pi]),
        idxbx=np.array([5, 6, 9]),
    )


def usv_guidance2() -> Model:
    """12-state guidance v2 with yaw-rate loop (reference
    scripts/usv_guidance2/usv_model.py; T1 = 0.4)."""
    T1 = 0.4

    def f(x, u_ctl, p):
        _nx, _ny, psi, _s, _c, u, v, r, _ye, ak, _psid, rd = x
        xned_dot = u * jnp.cos(psi) - v * jnp.sin(psi)
        yned_dot = u * jnp.sin(psi) + v * jnp.cos(psi)
        return jnp.stack([
            xned_dot,
            yned_dot,
            r,
            jnp.cos(psi) * r,
            -jnp.sin(psi) * r,
            jnp.zeros_like(psi),
            jnp.zeros_like(psi),
            (rd - r) / T1,
            -xned_dot * jnp.sin(ak) + yned_dot * jnp.cos(ak),
            jnp.zeros_like(psi),
            rd,
            u_ctl[0],
        ])

    return Model(
        name="usv_guidance2", nx=12, nu=1, np_=0, f=f,
        f_dep=(2, 5, 6, 7, 9, 11, 12),
        x0=np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0,
                     0.0, 0.0, 0.0, 0.0]),
        state_names=("nedx", "nedy", "psi", "sinpsi", "cospsi", "u", "v", "r",
                     "ye", "ak", "psid", "rd"),
        control_names=("Urddot",),
        lbu=np.array([-0.7]), ubu=np.array([0.7]), idxbu=np.array([0]),
        lbx=np.array([-1.0]), ubx=np.array([1.0]), idxbx=np.array([11]),
    )


def usv_guidance3() -> Model:
    """11-state guidance v3 with course-angle kinematics (reference
    scripts/usv_guidance3/usv_model.py; chi = psi + beta, T1 = 1.0)."""
    T1 = 1.0

    def f(x, u_ctl, p):
        _nx, _ny, psi, _s, _c, u, v, r, _ye, ak, rd = x
        beta = jnp.arctan2(v, u + 0.001)
        chi = psi + beta
        xned_dot = u * jnp.cos(psi) - v * jnp.sin(psi)
        yned_dot = u * jnp.sin(psi) + v * jnp.cos(psi)
        return jnp.stack([
            xned_dot,
            yned_dot,
            r,
            jnp.cos(chi) * r,
            -jnp.sin(chi) * r,
            jnp.zeros_like(psi),
            jnp.zeros_like(psi),
            (rd - r) / T1,
            -xned_dot * jnp.sin(ak) + yned_dot * jnp.cos(ak),
            jnp.zeros_like(psi),
            u_ctl[0],
        ])

    return Model(
        name="usv_guidance3", nx=11, nu=1, np_=0, f=f,
        f_dep=(2, 5, 6, 7, 9, 10, 11),
        x0=np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0]),
        state_names=("nedx", "nedy", "psi", "sinpsi", "cospsi", "u", "v", "r",
                     "ye", "ak", "rd"),
        control_names=("Urddot",),
        lbu=np.array([-0.25]), ubu=np.array([0.25]), idxbu=np.array([0]),
        lbx=np.array([-0.35]), ubx=np.array([0.35]), idxbx=np.array([10]),
    )


def usv_guidance4() -> Model:
    """Minimal 4-state error-kinematics model; control IS the desired heading
    error (reference scripts/usv_guidance4/usv_model.py; T1 = 0.2)."""
    T1 = 0.2

    def f(x, u_ctl, p):
        u, v, _ye, chie = x
        beta = jnp.arctan2(v, u + 0.001)
        psie = chie - beta
        return jnp.stack([
            jnp.zeros_like(u),
            jnp.zeros_like(u),
            u * jnp.sin(psie) + v * jnp.cos(psie),
            (u_ctl[0] - psie) / T1,
        ])

    return Model(
        name="usv_guidance4", nx=4, nu=1, np_=0, f=f,
        f_dep=(0, 1, 3, 4),
        x0=np.zeros(4),
        state_names=("u", "v", "ye", "chie"),
        control_names=("psied",),
        lbu=np.array([-np.pi / 2]), ubu=np.array([np.pi / 2]),
        idxbu=np.array([0]),
    )


def usv_guidance5() -> Model:
    """5-state variant adding the rate-limited desired-heading state
    (reference scripts/usv_guidance5/usv_model.py; T1 = 1.0)."""
    T1 = 1.0

    def f(x, u_ctl, p):
        u, v, _ye, chie, psied = x
        beta = jnp.arctan2(v, u + 0.001)
        psie = chie - beta
        return jnp.stack([
            jnp.zeros_like(u),
            jnp.zeros_like(u),
            u * jnp.sin(psie) + v * jnp.cos(psie),
            (psied - psie) / T1,
            u_ctl[0],
        ])

    return Model(
        name="usv_guidance5", nx=5, nu=1, np_=0, f=f,
        f_dep=(0, 1, 3, 4, 5),
        x0=np.zeros(5),
        state_names=("u", "v", "ye", "chie", "psied"),
        control_names=("Upsieddot",),
        lbu=np.array([-0.25]), ubu=np.array([0.25]), idxbu=np.array([0]),
        lbx=np.array([-np.pi / 2]), ubx=np.array([np.pi / 2]),
        idxbx=np.array([4]),
    )


def usv_guidance_ca() -> Model:
    """9-state CA guidance with jerk-level input and 8 hard distance
    constraints (reference scripts/usv_guidance_ca/usv_model.py; T1 = 1.0)."""
    T1 = 1.0

    def f(x, u_ctl, p):
        u, v, _ye, chie, psied, _xn, _yn, psi, psieddot = x
        beta = jnp.arctan2(v, u + 0.001)
        psie = chie - beta
        return jnp.stack([
            jnp.zeros_like(u),
            jnp.zeros_like(u),
            u * jnp.sin(psie) + v * jnp.cos(psie),
            (psied - psie) / T1,
            psieddot,
            u * jnp.cos(psi) - v * jnp.sin(psi),
            u * jnp.sin(psi) + v * jnp.cos(psi),
            (psied - psie) / T1,
            u_ctl[0],
        ])

    def h(x, p):
        return _obstacle_distances(x[5], x[6], p, 8)

    return Model(
        name="usv_guidance_ca", nx=9, nu=1, np_=16, f=f,
        f_dep=(0, 1, 3, 4, 7, 8, 9), h_dep=(5, 6),
        x0=np.zeros(9),
        state_names=("u", "v", "ye", "chie", "psied", "xned", "yned", "psi",
                     "psieddot"),
        control_names=("Upsieddotdot",),
        lbu=np.array([-1.0]), ubu=np.array([1.0]), idxbu=np.array([0]),
        lbx=np.array([-1.0]), ubx=np.array([1.0]), idxbx=np.array([8]),
        h=h, nh=8,
        lh=np.zeros(8), uh=np.full(8, 1e6),
    )


def usv_guidance_ca1() -> Model:
    """FLAGSHIP: 8-state CA guidance model of the 2024 paper (reference
    scripts/usv_guidance_ca1/usv_model.py:60-199).

    x = (u, v, ye, chie, psied, xned, yned, psi); U = psied_dot in
    [-0.5, 0.5] rad/s; dynamics :117-128 with beta = atan2(v, u+0.001),
    psie = chie - beta, T1 = 1.0; 8 soft obstacle-distance constraints
    (:133-140, distance_min = 1.5 at :160, softened with lsh = -0.2 in
    acados_settings.py:154-178).
    """
    T1 = 1.0

    def f(x, u_ctl, p):
        u, v, _ye, chie, psied, _xn, _yn, psi = x
        beta = jnp.arctan2(v, u + 0.001)
        psie = chie - beta
        psie_rate = (psied - psie) / T1
        return jnp.stack([
            jnp.zeros_like(u),
            jnp.zeros_like(u),
            u * jnp.sin(psie) + v * jnp.cos(psie),
            psie_rate,
            u_ctl[0],
            u * jnp.cos(psi) - v * jnp.sin(psi),
            u * jnp.sin(psi) + v * jnp.cos(psi),
            psie_rate,
        ])

    def h(x, p):
        return _obstacle_distances(x[5], x[6], p, 8)

    return Model(
        name="usv_guidance_ca1", nx=8, nu=1, np_=16, f=f,
        f_dep=(0, 1, 3, 4, 7, 8), h_dep=(5, 6),
        x0=np.zeros(8),
        state_names=("u", "v", "ye", "chie", "psied", "xned", "yned", "psi"),
        control_names=("Upsieddot",),
        lbu=np.array([-0.5]), ubu=np.array([0.5]), idxbu=np.array([0]),
        h=h, nh=8,
        lh=np.full(8, 1.5), uh=np.full(8, 1e6),
    )


# ---------------------------------------------------------------------------
# Race car (the upstream acados demo the repo was forked from)
# ---------------------------------------------------------------------------

def race_cars(kappa_fn=None) -> Model:
    """Frenet-frame spatial bicycle model (reference
    scripts/race_cars/bycicle_model.py:60-120).

    The original interpolates track curvature kappa(s) from a gitignored
    ``tracks/`` data dir; here `kappa_fn` is injectable (default: straight
    track, kappa = 0).  Note the independent variable is arc length s, not
    time — dynamics below are the reference's d/ds expressions verbatim.
    """
    m, C1, C2 = 0.043, 0.5, 15.5
    Cm1, Cm2, Cr0, Cr2 = 0.28, 0.05, 0.011, 0.006
    straight = kappa_fn is None
    if straight:
        def kappa_fn(s):
            return jnp.zeros_like(s)

    def f(x, u_ctl, p):
        s, n, alpha, v, D, delta = x
        Fxd = (Cm1 - Cm2 * v) * D - Cr2 * v * v - Cr0 * jnp.tanh(5 * v)
        sdota = (v * jnp.cos(alpha + C1 * delta)) / (1 - kappa_fn(s) * n)
        return jnp.stack([
            sdota,
            v * jnp.sin(alpha + C1 * delta),
            v * C2 * delta - kappa_fn(s) * sdota,
            Fxd / m * jnp.cos(C1 * delta),
            u_ctl[0],
            u_ctl[1],
        ])

    def h(x, p):
        """(a_long, a_lat, n, D, delta) constraint vector
        (reference bycicle_model.py:113-167)."""
        s, n, alpha, v, D, delta = x
        Fxd = (Cm1 - Cm2 * v) * D - Cr2 * v * v - Cr0 * jnp.tanh(5 * v)
        a_long = Fxd / m
        a_lat = C2 * v * v * delta + Fxd * jnp.sin(C1 * delta) / m
        return jnp.stack([a_long, a_lat, n, D, delta])

    return Model(
        name="race_cars", nx=6, nu=2, np_=0, f=f,
        # straight track (kappa = 0): f never reads s or n; an injected
        # curvature interpolant reads both -> dense
        f_dep=((2, 3, 4, 5, 6, 7) if straight
               else (0, 1, 2, 3, 4, 5, 6, 7)),
        h_dep=(1, 3, 4, 5),
        x0=np.array([-2.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
        state_names=("s", "n", "alpha", "v", "D", "delta"),
        control_names=("derD", "derDelta"),
        lbu=np.array([-10.0, -2.0]), ubu=np.array([10.0, 2.0]),
        idxbu=np.array([0, 1]),
        lbx=np.array([-12.0]), ubx=np.array([12.0]), idxbx=np.array([1]),
        h=h, nh=5,
        lh=np.array([-4.0, -4.0, -0.12, -1.0, -0.40]),
        uh=np.array([4.0, 4.0, 0.12, 1.0, 0.40]),
    )
