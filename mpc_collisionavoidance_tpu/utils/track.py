"""Race-track geometry: synthetic closed tracks, a JAX curvature
interpolant, and the Frenet <-> Cartesian transforms.

The reference race-car example loads a measured track table and builds a
CasADi bspline curvature interpolant ``kapparef_s`` that appears INSIDE the
dynamics (reference scripts/race_cars/bycicle_model.py:46-55), and converts
solver output back to Cartesian with ``transformProj2Orig`` /
``transformOrig2Proj`` (reference scripts/race_cars/time2spatial.py:40-99).
The track data dir itself is gitignored upstream (.gitignore:41), so this
module generates a synthetic closed circuit with the same structure —
uniform arc-length samples of (s, x, y, psi, kappa) — and implements both
transforms as total, vmappable JAX functions.

Device notes: the samples are UNIFORM in s, so interpolation is O(1) index
arithmetic + gathers (no searchsorted), elementwise over arbitrary batch
shapes — safe inside the lane engine's (N, L) vectorized dynamics; the
curvature table is periodic Catmull-Rom, giving a C1 curve like the
reference's bspline.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Track(NamedTuple):
    """Uniform arc-length track table (the content of the reference's
    getTrack(): [s0, xref, yref, psiref, kapparef])."""

    s0: np.ndarray        # (M,) arc length, s0[0] = 0, uniform spacing
    xref: np.ndarray      # (M,) centerline x
    yref: np.ndarray      # (M,) centerline y
    psiref: np.ndarray    # (M,) centerline heading, UNWRAPPED (+2*pi/lap)
    kapparef: np.ndarray  # (M,) signed curvature
    length: float         # total path length (s of closing point)


def make_synthetic_track(n_samples: int = 512, radius: float = 0.45,
                         straight: float = 1.6,
                         chicane_amp: float = 0.35) -> Track:
    """Closed LMS-scale circuit: two straights + two U-turns, with a
    sinusoidal curvature chicane superposed on the straights so kappa is
    smooth, sign-changing, and non-trivial everywhere (path length ~= the
    upstream LMS track's 8.71 m).

    Built by integrating psi' = kappa(s) over uniform ds and then closing
    the loop exactly (subtracting the linear drift in x, y, psi), so the
    table is consistent: x' = cos psi, y' = sin psi, psi' = kappa.
    """
    # curvature profile over one lap, piecewise by arc length:
    #   [0, a): straight w/ chicane, [a, a+piR): left U-turn,
    #   [a+piR, 2a+piR): straight w/ chicane, [2a+piR, 2a+2piR): U-turn
    a, R = straight, radius
    L = 2 * a + 2 * np.pi * R
    s = np.linspace(0.0, L, n_samples, endpoint=False)
    ds = L / n_samples

    def base_kappa(si):
        si = np.mod(si, L)
        in_turn1 = (si >= a) & (si < a + np.pi * R)
        in_turn2 = si >= 2 * a + np.pi * R
        turn = (in_turn1 | in_turn2).astype(float) / R
        # chicane: one full sine period per straight, zero at the ends
        t1 = np.clip(si / a, 0, 1)
        t2 = np.clip((si - a - np.pi * R) / a, 0, 1)
        chic = (np.sin(2 * np.pi * t1) * ((si < a).astype(float))
                + np.sin(2 * np.pi * t2)
                * (((si >= a + np.pi * R) & (si < 2 * a + np.pi * R))
                   .astype(float)))
        return turn + chicane_amp * chic

    kappa = base_kappa(s)
    # integrate heading/position, then close the loop exactly
    psi = np.concatenate([[0.0], np.cumsum(kappa)[:-1]]) * ds
    psi_end = psi[-1] + kappa[-1] * ds
    # heading must advance exactly 2*pi per lap: spread the correction
    psi = psi + (2 * np.pi - psi_end) * s / L
    kappa = np.gradient(psi, ds)          # consistent kappa after closure
    x = np.concatenate([[0.0], np.cumsum(np.cos(psi))[:-1]]) * ds
    y = np.concatenate([[0.0], np.cumsum(np.sin(psi))[:-1]]) * ds
    # remove residual endpoint drift so the loop closes in position too
    x_end = x[-1] + np.cos(psi[-1]) * ds
    y_end = y[-1] + np.sin(psi[-1]) * ds
    x = x - x_end * s / L
    y = y - y_end * s / L

    return Track(s0=s, xref=x, yref=y, psiref=psi, kapparef=kappa,
                 length=float(L))


# ---------------------------------------------------------------------------
# periodic Catmull-Rom interpolation on the uniform table (JAX, elementwise
# over any batch shape — usable inside jitted dynamics)

def _interp_periodic(table, s, length, wrap_per_lap=0.0):
    """Catmull-Rom interpolation of a uniform periodic table at arc s.

    `wrap_per_lap` is added per completed lap (2*pi for psiref, 0 for
    x/y/kappa) so unwrapped quantities stay continuous across the seam.
    """
    tab = jnp.asarray(table)
    M = tab.shape[0]
    laps = jnp.floor(s / length)
    sm = s - laps * length
    t = sm / length * M
    i1 = jnp.clip(t.astype(jnp.int32), 0, M - 1)
    frac = t - i1
    i0 = jnp.mod(i1 - 1, M)
    i2 = jnp.mod(i1 + 1, M)
    i3 = jnp.mod(i1 + 2, M)
    # seam correction for unwrapped tables (psi jumps by wrap_per_lap)
    p0 = tab[i0] - jnp.where(i1 == 0, wrap_per_lap, 0.0)
    p1 = tab[i1]
    p2 = tab[i2] + jnp.where(i2 == 0, wrap_per_lap, 0.0)
    p3 = tab[i3] + jnp.where(i3 <= 1, wrap_per_lap, 0.0)
    f2 = frac * frac
    f3 = f2 * frac
    out = 0.5 * ((2 * p1) + (-p0 + p2) * frac
                 + (2 * p0 - 5 * p1 + 4 * p2 - p3) * f2
                 + (-p0 + 3 * p1 - 3 * p2 + p3) * f3)
    return out + laps * wrap_per_lap


def make_kappa_fn(track: Track):
    """Curvature interpolant kappa(s) for use inside model dynamics — the
    JAX equivalent of the reference's CasADi ``kapparef_s`` bspline
    (bycicle_model.py:55)."""

    def kappa_fn(s):
        return _interp_periodic(track.kapparef, s, track.length)

    return kappa_fn


# ---------------------------------------------------------------------------
# Frenet <-> Cartesian (reference time2spatial.py:40-99)

def transform_proj2orig(track: Track, s, n, alpha=0.0, v=0.0):
    """(s, n, alpha, v) -> (x, y, psi, v): offset the centerline point at
    arc s by n along its left normal (reference transformProj2Orig
    conventions: x = x0 - n sin psi0, y = y0 + n cos psi0)."""
    s = jnp.asarray(s)
    x0 = _interp_periodic(track.xref, s, track.length)
    y0 = _interp_periodic(track.yref, s, track.length)
    psi0 = _interp_periodic(track.psiref, s, track.length,
                            wrap_per_lap=2 * jnp.pi)
    x = x0 - n * jnp.sin(psi0)
    y = y0 + n * jnp.cos(psi0)
    return x, y, psi0 + alpha, v


def transform_orig2proj(track: Track, x, y, psi, v=0.0):
    """(x, y, psi, v) -> (s, n, alpha, v): project onto the centerline.

    Fixed-shape: nearest-sample argmin over the table followed by one
    local linearized refinement (the reference does two-point inverse
    interpolation over its table, time2spatial.py:73-99)."""
    xr = jnp.asarray(track.xref)
    yr = jnp.asarray(track.yref)
    d2 = (x - xr) ** 2 + (y - yr) ** 2
    i = jnp.argmin(d2)
    s_i = jnp.asarray(track.s0)[i]
    psi_i = jnp.asarray(track.psiref)[i]
    # refine: tangential offset of (x, y) from the nearest sample
    dt = ((x - xr[i]) * jnp.cos(psi_i) + (y - yr[i]) * jnp.sin(psi_i))
    s_star = s_i + dt
    x0 = _interp_periodic(track.xref, s_star, track.length)
    y0 = _interp_periodic(track.yref, s_star, track.length)
    psi0 = _interp_periodic(track.psiref, s_star, track.length,
                            wrap_per_lap=2 * jnp.pi)
    nval = -(x - x0) * jnp.sin(psi0) + (y - y0) * jnp.cos(psi0)
    alpha = jnp.mod(psi - psi0 + jnp.pi, 2 * jnp.pi) - jnp.pi
    return jnp.mod(s_star, track.length), nval, alpha, v
