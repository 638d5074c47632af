"""Wall-clock stage timing (the reference had two ad-hoc chrono timers,
``pipeline.cpp:87-92`` and ``clSLIC.cpp:295-300``; here every stage can be
timed uniformly) plus jax.profiler trace helpers."""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kw):
    """Median wall time of ``fn(*args)`` to ``block_until_ready``, after
    warmup.

    Returns (median_seconds, last_result).
    """
    result = None
    for _ in range(warmup):
        result = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result


@contextlib.contextmanager
def trace(path: str | None):
    """Optional jax.profiler trace context (``path=None`` disables)."""
    if path is None:
        yield
        return
    with jax.profiler.trace(path):
        yield
