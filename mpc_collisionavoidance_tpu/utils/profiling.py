"""Tracing / profiling utilities (SURVEY.md section 5).

The reference's only instrumentation is wall-clock around each solve with
a running sum/max printed at exit (reference
scripts/usv_guidance_ca1/main.py:133-144,197-198).  `SolveTimer` keeps that
exact surface (avg/max, now plus percentiles and solves/s) and `trace`
wraps `jax.profiler` for per-kernel device timelines the reference never
had.
"""

import contextlib
import time
from typing import Optional

import numpy as np


class SolveTimer:
    """Accumulates per-solve wall-clock like the reference harness.

    >>> timer = SolveTimer(batch=4096)
    >>> with timer.tick():
    ...     run_one_step()
    >>> print(timer.summary())
    """

    def __init__(self, batch: int = 1):
        self.batch = batch
        self.samples = []

    @contextlib.contextmanager
    def tick(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    # reference names: avg/max compute time (main.py:197-198)
    @property
    def avg(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    @property
    def max(self) -> float:
        return float(np.max(self.samples)) if self.samples else 0.0

    def percentile(self, q) -> float:
        return float(np.percentile(self.samples, q)) if self.samples else 0.0

    @property
    def solves_per_s(self) -> float:
        total = float(np.sum(self.samples))
        return len(self.samples) * self.batch / total if total else 0.0

    def summary(self) -> dict:
        return {
            "ticks": len(self.samples),
            "batch": self.batch,
            "avg_ms": 1e3 * self.avg,
            "max_ms": 1e3 * self.max,
            "p50_ms": 1e3 * self.percentile(50),
            "p99_ms": 1e3 * self.percentile(99),
            "solves_per_s": self.solves_per_s,
        }


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """jax.profiler trace scope; view with TensorBoard/xprof."""
    import jax
    jax.profiler.start_trace(log_dir, host_tracer_level=host_tracer_level)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> Optional[dict]:
    """Per-device HBM stats where the backend exposes them (None on CPU)."""
    import jax
    dev = device or jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    if not stats:
        return None
    return {k: stats[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                  "bytes_limit") if k in stats}
