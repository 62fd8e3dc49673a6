"""Framework configuration layer.

The reference has NO config system: dims live in C++ #defines, weights and
horizons in Python literals, rates hard-coded per node — with two latent
hazards SURVEY.md section 5 documents (loop rate accidentally tied to the
horizon macro; a dim macro that disagrees with the state enum).  This
module is the explicit replacement: one validated dataclass tree covering
model choice, horizon, solver engine, and mesh/batch shape, serializable
to/from plain dicts (JSON-able) so experiment configs are artifacts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from mpc_collisionavoidance_tpu.models import registry
from mpc_collisionavoidance_tpu.ocp import builders

#: lane-engine Riccati sweeps: the plain `lax.scan` sweep, the Triton
#: kernel (kernels/riccati_pallas.py, NVIDIA GPUs), the kernel up to its
#: KERNEL_MAX_NX and `lax` above it ("auto"), the parallel scan
RICCATI_BACKENDS = ("lax", "pallas", "auto", "pscan")

#: the sweep the production preset runs on each platform
PRESET_RICCATI = {"gpu": "auto", "cpu": "lax"}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    engine: str = "lane"          # "lane" (throughput) | "instance" (vmap)
    ipm_iters: int = 12
    ipm_tol: float = 1e-7
    riccati: str = "lax"          # lane engine: "lax" | "pallas" (the
                                  # Triton sweep kernel, GPU) | "auto"
                                  # (kernel up to KERNEL_MAX_NX, lax
                                  # above) | "pscan"
    qp_backend: str = "riccati"   # instance engine: "riccati" | "dense"
                                  # (full condensing, the qpOASES role)
    centering: str = "fixed"      # "fixed" | "adaptive" (lane engine:
                                  # per-lane sigma heuristic, ~8 IPM
                                  # iters to the f32 gap floor) |
                                  # "mehrotra" (both engines: full
                                  # predictor-corrector + use with
                                  # mu0="auto" for 1e5-scale weights,
                                  # docs/PERF.md)
    mu0: object = 1.0             # initial barrier weight: float | "auto"
    extra_iters: int = 0          # lane engine: stall-escalation budget —
                                  # extra IPM iterations run ONLY while
                                  # some lane's gap exceeds stall_tol
                                  # (ops/ipm_lanes.py); the production
                                  # schedule's mission-length insurance
    stall_tol: Optional[float] = None  # escalation gate (None = dtype-
                                       # aware convergence tolerance)
    dtype: str = "float32"

    def __post_init__(self):
        if self.engine not in ("lane", "instance"):
            raise ValueError(f"unknown engine '{self.engine}'")
        if self.extra_iters < 0:
            raise ValueError(f"extra_iters must be >= 0")
        if self.extra_iters and self.engine == "instance":
            raise ValueError("stall escalation (extra_iters > 0) is "
                             "lane-engine-only")
        if self.riccati not in RICCATI_BACKENDS:
            raise ValueError(f"unknown riccati backend '{self.riccati}'")
        if self.qp_backend not in ("riccati", "dense"):
            raise ValueError(f"unknown qp_backend '{self.qp_backend}'")
        if self.centering not in ("fixed", "adaptive", "mehrotra"):
            raise ValueError(f"unknown centering '{self.centering}'")
        if self.centering == "adaptive" and self.engine == "instance":
            raise ValueError("adaptive centering is lane-engine-only; the "
                             "instance engine supports fixed/mehrotra")
        if isinstance(self.mu0, str) and self.mu0 != "auto":
            raise ValueError(f"unknown mu0 '{self.mu0}' (float or 'auto')")
        if self.engine == "instance" and self.riccati != "lax":
            raise ValueError(f"{self.riccati} riccati requires the lane "
                             "engine")
        if self.engine == "lane" and self.qp_backend != "riccati":
            raise ValueError("the dense QP backend requires the "
                             "instance engine")

    def build(self, spec):
        """Instantiate this engine config for an already-built OCPSpec."""
        if self.engine == "lane":
            from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver
            return LaneRTISolver(spec, ipm_iters=self.ipm_iters,
                                 ipm_tol=self.ipm_tol,
                                 riccati=self.riccati,
                                 centering=self.centering,
                                 mu0=self.mu0,
                                 extra_iters=self.extra_iters,
                                 stall_tol=self.stall_tol)
        from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver
        return RTISolver(spec, ipm_iters=self.ipm_iters,
                         ipm_tol=self.ipm_tol,
                         qp_backend=self.qp_backend,
                         centering=self.centering,
                         mu0=self.mu0)


def production_engine(platform: Optional[str] = None) -> SolverConfig:
    """The single production solver preset — bench.py, the RT server CLI
    defaults, and `cli.py run/mission` all consume THIS function, so a
    user standing up any surface gets the same engineered engine the
    headline bench advertises (round-4 VERDICT: three surfaces had three
    different defaults).

    Lane engine, per-lane adaptive centering at 4 fixed IPM iterations,
    plus a stall-escalation budget so the schedule holds its 1e-5
    duality-gap health gate at the reference's full 1000-tick mission
    length (reference scripts/usv_guidance_ca1/main.py:116), not just the
    bench window — see docs/PERF.md "Mission-length convergence".

    The Riccati sweep follows the platform (`PRESET_RICCATI`): on a GPU
    "auto", the Triton kernel for models up to the kernel's KERNEL_MAX_NX
    states and the plain `lax` sweep above (kernels/riccati_pallas.py says
    why); the `lax` sweep on the CPU (dev/test).  Any other platform
    raises: there is no silent default.  Explicit CLI
    flags still override individual fields.
    """
    if platform is None:
        import jax
        platform = jax.default_backend()
    if platform not in PRESET_RICCATI:
        raise ValueError(
            f"no production preset for platform '{platform}'; known: "
            f"{sorted(PRESET_RICCATI)}")
    # The schedule: adaptive centering, FOUR fixed iterations, then
    # stall escalation — a bounded while_loop of extra iterations that
    # runs only while some lane's duality gap exceeds the tolerance
    # (ops/ipm_lanes.py).  Escalation makes the fixed count a FLOOR, not
    # a correctness knob: total sweeps per tick = max(base, what the
    # worst lane actually needs to reach tol).  extra_iters=24: an
    # unused budget is FREE (the loop exits on tolerance), so the cap is
    # sized to never bind.
    #
    # mu0="auto" (gradient-proportional initial barrier, per lane, lower
    # clip 1e-3): a warm-started RTI QP is near-converged, and
    # restarting its barrier at 1.0 burns ~2 iterations just walking mu
    # back down; gradient scaling starts it where the QP actually is
    # while 1e5-weight cold QPs (usv_position_control) still get a large
    # mu0.
    #
    # ipm_tol == stall_tol == 3e-6: ONE production tolerance, 3.3x margin
    # under bench.py's 1e-5 health gate.  The status-0 gate and the
    # escalation stop target must agree, or mid-mission solves stopped
    # at 3e-6 report status 1 against a 5e-7 gate they were never asked
    # to meet.
    return SolverConfig(
        engine="lane",
        ipm_iters=4,
        ipm_tol=3e-6,
        extra_iters=24,
        stall_tol=3e-6,
        mu0="auto",
        riccati=PRESET_RICCATI[platform],
        centering="adaptive",
    )


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    n_devices: Optional[int] = None   # None = all visible
    axis_name: str = "dp"
    batch_per_device: int = 1024


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Top-level config: model + horizon + solver + parallel layout."""
    model: str = "usv_guidance_ca1"
    N: int = 100
    Tf: float = 5.0
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)

    def __post_init__(self):
        known = sorted(set(registry.names()) | set(builders.BUILDERS))
        if self.model not in known:
            raise ValueError(
                f"unknown model '{self.model}'; known: {known}")
        if self.N < 1 or self.Tf <= 0:
            raise ValueError(f"bad horizon N={self.N}, Tf={self.Tf}")

    # ------------------------------------------------------------------
    def build_spec(self):
        return builders.build(self.model, Tf=self.Tf, N=self.N)

    def build_solver(self):
        """Instantiate the configured solver engine for this OCP."""
        return self.solver.build(self.build_spec())

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FrameworkConfig":
        d = dict(d)
        if "solver" in d and isinstance(d["solver"], dict):
            d["solver"] = SolverConfig(**d["solver"])
        if "parallel" in d and isinstance(d["parallel"], dict):
            d["parallel"] = ParallelConfig(**d["parallel"])
        return cls(**d)
