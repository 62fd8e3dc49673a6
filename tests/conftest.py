"""Test configuration: force all test compute onto the host CPU (8 virtual
devices) in float64, so numerical oracles are tight and multi-device
sharding logic is exercised without a GPU (SURVEY.md section 4 test
strategy).

XLA backends initialize lazily, so setting XLA_FLAGS and the programmatic
default-device config here, before any backend is touched, still works
when jax was imported earlier.

Tests that need a GPU carry the `gpu` marker and the `gpu` fixture, which
skips them when JAX finds no GPU; they run on a card with `pytest -m gpu`.
The decision is made inside the fixture, never while a module is
imported, so every pytest-xdist worker collects the same tests.
"""

import functools
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from mpc_collisionavoidance_tpu.utils.device import (  # noqa: E402
    enable_compile_cache)

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

# Persistent XLA compilation cache: most of the suite's wall time is
# repeated CPU jit compiles of near-identical solver programs; caching
# them across tests AND across runs measured a 3.6x on a representative
# compile (4.0 s -> 1.1 s second-process load).  The CPU AOT loader
# prints benign machine-feature warnings (prefer-no-scatter/gather
# pseudo-features) on load — same-host loads are safe.
enable_compile_cache()


def cpu_devices(n=8):
    return jax.devices("cpu")[:n]


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run on a card with `pytest -m gpu`)")
    return devices[0]


@pytest.fixture
def interpret_riccati_kernel(monkeypatch):
    """Route riccati="pallas" through the Triton kernel in interpret mode,
    so the lane engine runs the kernel's own code on the CPU.  Interpret
    mode is a test-only argument of the wrapper, never a config value."""
    from mpc_collisionavoidance_tpu.kernels import riccati_pallas

    monkeypatch.setattr(
        riccati_pallas, "lqr_solve_lanes_pallas",
        functools.partial(riccati_pallas.lqr_solve_lanes_pallas,
                          interpret=True))
