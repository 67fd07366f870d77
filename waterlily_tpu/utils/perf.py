"""Performance accounting: step timing, MLUPS, and profiler hooks.

The reference's performance harness lives in an external benchmarks repo
(README.md:145-151); its in-repo proxy is an allocation gate.  The
equivalents provided here: steady-state step timing via `lax.scan` batches,
cell-updates-per-second (MLUPS — the headline metric of the 2024 WaterLily
paper), and `jax.profiler` trace capture for kernel-level analysis.
"""
from __future__ import annotations

import contextlib
import math
import time

import jax

__all__ = ["mlups", "time_steps", "trace_profile"]


def mlups(dims, n_steps: int, seconds: float) -> float:
    """Million cell-updates per second for ``n_steps`` over grid ``dims``."""
    return math.prod(dims) * n_steps / seconds / 1e6


def time_steps(sim, n_steps: int, warmup: int = 10, remeasure=None) -> dict:
    """Time ``n_steps`` of a Simulation under `lax.scan` (no host sync).

    Returns wall seconds, per-step seconds, and MLUPS over interior cells.
    """
    if remeasure is None:
        remeasure = False
    # warm up with the SAME scan length so the timed region never compiles
    sim.steps(n_steps, remeasure=remeasure)
    jax.block_until_ready(sim.flow.u)
    t0 = time.perf_counter()
    sim.steps(n_steps, remeasure=remeasure)
    jax.block_until_ready(sim.flow.u)
    dt = time.perf_counter() - t0
    dims = tuple(s - 2 for s in sim.cfg.S)
    return {"seconds": dt, "sec_per_step": dt / n_steps,
            "mlups": mlups(dims, n_steps, dt), "dims": dims, "steps": n_steps}


@contextlib.contextmanager
def trace_profile(logdir: str = "/tmp/waterlily_trace"):
    """Capture a jax.profiler trace around a block (view with XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
