"""Tracing / profiling.

The reference has none (SURVEY.md §5: only a frame-delta Time helper).  Here:
``phase_timer`` wall-clocks named phases (blocking on device results so the
numbers mean something under async dispatch), and ``device_trace`` wraps
``jax.profiler`` for Perfetto-grade device traces.
"""

from __future__ import annotations

import contextlib
import logging
import time

import jax

log = logging.getLogger("treee_tpu")

_TIMINGS: dict[str, list[float]] = {}


@contextlib.contextmanager
def phase_timer(name: str, block_on=None):
    """Wall-clock a phase; optionally block on a pytree of device arrays."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        _TIMINGS.setdefault(name, []).append(dt)
        log.info("phase %-24s %8.3f s", name, dt)


def timings() -> dict[str, list[float]]:
    """All recorded phase durations (seconds) this process."""
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace (view in Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
