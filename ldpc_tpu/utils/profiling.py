"""Tracing / profiling helpers (SURVEY.md §5.1).

The reference had nothing beyond wall-clock timing; here:
  * trace(): jax.profiler context emitting TensorBoard/Perfetto traces (XLA
    ops and the CUDA kernel appear on the device timeline);
  * timed(): block_until_ready-bracketed wall timer;
  * compiled_cost(): XLA's own FLOP/byte estimates for a jitted callable.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Callable, Dict, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context into `logdir` (view with
    TensorBoard's profile plugin or Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable, *args, reps: int = 10) -> float:
    """Median seconds per call after one warm-up call (which compiles);
    every call is waited for with block_until_ready inside its interval."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def compiled_cost(fn: Callable, *args) -> Optional[Dict[str, Any]]:
    """XLA cost analysis (flops, bytes accessed) of fn jitted on *args."""
    try:
        compiled = jax.jit(fn).lower(*args).compile()
        return compiled.cost_analysis()
    except Exception:
        return None
