"""Profiling and timing helpers (SURVEY.md §5: the reference has only
chrono/rdtsc micro-timers in its benchmark mains — tests/tools.h:28-33,
FastGaussianNoise.hpp:116-122).  Here: jax.profiler device traces, and
wall-clock timing of device work that ends in block_until_ready."""
from __future__ import annotations

import contextlib
import statistics
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with jax.profiler.TraceAnnotation(name):
        yield


def time_call(fn, *args, warmup: int = 2, reps: int = 10) -> dict:
    """Seconds per call of fn(*args) after `warmup` untimed calls (so
    compilation is not counted), two ways:

      "median", "min": single calls, each ended by block_until_ready — what
                       one caller waits, host dispatch included;
      "pipelined":     `reps` calls issued back to back and one
                       block_until_ready on the last, divided by `reps` —
                       the device's time per call once dispatch overlaps it.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    pipelined = (time.perf_counter() - t0) / reps
    return {"median": statistics.median(times), "min": min(times),
            "pipelined": pipelined, "reps": reps}


class WallTimer:
    """Chrono-style accumulator (reference tests/tools.h:28-33)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total += time.perf_counter() - t0
            self.count += 1

    @property
    def mean_us(self) -> float:
        return (self.total / self.count) * 1e6 if self.count else 0.0
