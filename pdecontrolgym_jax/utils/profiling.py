"""Profiling / timing helpers.

The reference's only timing artifact is ``time.time()`` + tqdm wall-clock in
``NS2Doptimization.py:72-73``. Here: a device-throughput meter (host clock
around work that ends in ``block_until_ready``) and a jax.profiler trace
context.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


def time_device_fn(fn: Callable, *args, repeats: int = 3) -> float:
    """Best wall-clock seconds for ``fn(*args)``, each run ending in
    ``block_until_ready`` on its outputs. Compiles/warms on the first
    (untimed) call."""
    g = jax.jit(fn)
    jax.block_until_ready(g(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(g(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def steps_per_second(fn: Callable, steps: int, *args, repeats: int = 3) -> float:
    """Throughput of a rollout-like fn that advances ``steps`` env-steps."""
    return steps / time_device_fn(fn, *args, repeats=repeats)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    """jax.profiler trace context for inspecting programs in TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
