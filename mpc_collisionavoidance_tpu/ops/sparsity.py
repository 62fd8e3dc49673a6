"""Structural input-dependency detection for model Jacobians.

The generic linearization paths propagate one tangent per (state +
control) coordinate through the RK4 rollout — nx + nu passes (the role of
the CasADi-generated forward VDE, reference scripts/usv_guidance_ca1/
acados_settings.py codegen).  But the guidance-error models are SPARSE in
their inputs: the flagship's dynamics never read ye, xned or yned
(reference scripts/usv_guidance_ca1/usv_model.py:117-128 — position only
enters the *constraint* h), so those tangent passes are structurally
trivial:

- a state coordinate f never reads contributes an EXACT identity column
  to the discrete map's Jacobian (dF/dx_j = e_j: the JVP with tangent
  e_j propagates all-zero intermediate tangents, so skipping the pass is
  bitwise identical to running it);
- a control coordinate f never reads contributes an exact zero column.

This is the same structural-sparsity information CasADi extracts
symbolically; here it is detected by probing `jax.jacfwd` at a few
generic random points — a column counts as structurally zero only if it
is EXACTLY 0.0 at every sample (a nonzero smooth term vanishing at
several generic points has measure zero).  The flagship needs only 6 of
9 dynamics tangents and 2 of 8 constraint tangents.

The lane engine's `jax.linearize` path skips the pruned passes; the
declarations also cut trace/compile size and are the honest statement of
model structure, pinned exact in tests/test_sparsity.py.
"""

import functools

import numpy as np


def _probe(apply_jac, n_in, np_, samples, seed):
    """Union of nonzero Jacobian columns over multi-scale random probes.

    ASSUMPTION (round-4 ADVICE): the exactly-zero-at-every-probe
    argument is measure-theoretic and holds for ANALYTIC dynamics; a
    region-gated dependency (`jnp.where` branch, saturation, a clamped /
    extrapolated interpolant like a kappa(s) table) can be invisible at
    probe points that all land in one region.  Mitigations here:
    probes span three magnitude tiers (0.1x / 1x / 10x the generic
    [0.3, 1.7] band, random signs) so regime switches like the hull's
    u > 1.25 piecewise drag (reference scripts/usv_pf_ca/
    usv_model.py:137-138) and saturations within +-17 are exercised on
    both sides; and tests/test_sparsity.py additionally cross-checks the
    declared sparsity against DENSE linearizations along a real
    closed-loop trajectory, which catches any dependency active in the
    operating envelope regardless of where the gate sits.  A model
    whose f/h gates on |x| > 17 or on exotic param values must declare
    its dependencies by hand rather than rely on this probe.
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    dep = np.zeros(n_in, bool)
    scales = (0.1, 1.0, 10.0)
    for k in range(samples):
        # generic points away from 0 (avoid symmetric cancellations) with
        # random signs; params in the obstacle-table range
        scale = scales[k % len(scales)]
        z = jnp.asarray(scale * rng.uniform(0.3, 1.7, n_in)
                        * rng.choice([-1.0, 1.0], n_in))
        p = (jnp.asarray(rng.uniform(1.0, 30.0, np_)) if np_
             else jnp.zeros((0,)))
        J = np.asarray(apply_jac(z, p))
        dep |= np.any(J != 0.0, axis=0)
    return tuple(int(i) for i in np.where(dep)[0])


@functools.lru_cache(maxsize=None)
def input_dependency(f, nx, nu, np_, samples=6, seed=0):
    """Indices of (x, u) coordinates `f(x, u, p)` structurally depends on.

    Skipped state columns of the discrete-map Jacobian are exact
    identity columns; skipped control columns are exact zeros — so a
    linearization restricted to these indices is BITWISE identical to
    the dense one.
    """
    import jax
    import jax.numpy as jnp

    jac = jax.jacfwd(lambda xu, p: jnp.asarray(f(xu[:nx], xu[nx:], p)))
    return _probe(jac, nx + nu, np_, samples, seed)


@functools.lru_cache(maxsize=None)
def constraint_dependency(h, nx, np_, samples=6, seed=1):
    """Indices of x coordinates `h(x, p)` structurally depends on
    (skipped columns of the constraint Jacobian are exact zeros)."""
    import jax
    import jax.numpy as jnp

    if h is None:
        return ()
    jac = jax.jacfwd(lambda x, p: jnp.asarray(h(x, p)))
    return _probe(jac, nx, np_, samples, seed)
