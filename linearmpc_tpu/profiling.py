"""Observability: solve counters, timing stats, and XLA profiler traces.

The reference's observability surface is per-step wall time in
``Simulation.solve_times`` plus the solver's discarded info struct
(SURVEY.md section 5). Here the engine can be instrumented to accumulate
batched-solve statistics (solves, iterations, wall time), and
``trace`` wraps ``jax.profiler`` for kernel-level device traces, and
``device_peaks`` holds the published peak rates a roofline divides by.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SolveStats:
    n_calls: int = 0
    n_solves: int = 0
    n_converged: int = 0
    total_iters: int = 0
    max_iters: int = 0
    total_time_s: float = 0.0
    batch_times_s: list = field(default_factory=list)

    @property
    def solves_per_s(self) -> float:
        return self.n_solves / self.total_time_s if self.total_time_s > 0 else 0.0

    @property
    def mean_iters(self) -> float:
        return self.total_iters / self.n_solves if self.n_solves else 0.0

    def p99_batch_latency(self) -> float:
        return float(np.percentile(self.batch_times_s, 99)) if self.batch_times_s else 0.0

    def summary(self) -> dict:
        return {
            "calls": self.n_calls,
            "solves": self.n_solves,
            "converged_frac": self.n_converged / self.n_solves if self.n_solves else 1.0,
            "mean_iters": round(self.mean_iters, 3),
            "max_iters": self.max_iters,
            "solves_per_s": round(self.solves_per_s, 1),
            "p99_batch_latency_s": self.p99_batch_latency(),
        }


def instrument(engine) -> SolveStats:
    """Wrap ``engine.solve_batch`` with counters; returns the live stats
    object (also stored as ``engine.stats``)."""
    stats = SolveStats()
    inner = engine.solve_batch

    def wrapped(thetas, warm=None):
        t0 = time.perf_counter()
        sol = inner(thetas, warm=warm)
        sol.U.block_until_ready()
        dt = time.perf_counter() - t0
        st = np.asarray(sol.status)
        it = np.asarray(sol.iters)
        stats.n_calls += 1
        stats.n_solves += len(st)
        stats.n_converged += int((st == 1).sum())
        stats.total_iters += int(it.sum())
        stats.max_iters = max(stats.max_iters, int(it.max()) if len(it) else 0)
        stats.total_time_s += dt
        stats.batch_times_s.append(dt)
        return sol

    engine.solve_batch = wrapped
    engine.stats = stats
    return stats


# -- device peaks ------------------------------------------------------------
#
# Published dense peaks by ``jax.devices()[0].device_kind``, from NVIDIA's
# H100 SXM data sheet (no sparsity; rates assume the full 700 W limit). A
# device missing from the table is an error, never a default: a rate
# divided by the wrong peak is worse than none.

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp8_flops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,     # outside the tensor cores
        "fp64_flops": 34e12,     # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column",
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peak rates of the device ``device_kind`` names; raises
    ``KeyError`` for a device not in ``PEAKS``."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


@contextlib.contextmanager
def trace(logdir: str):
    """XLA profiler trace around a block (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
