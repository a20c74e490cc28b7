"""Profiling hooks (SURVEY.md §5: reference has none; this build uses the
JAX profiler)."""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace_profile", "Timer"]


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block into
    ``logdir`` (view with TensorBoard or Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timer; ``stop(result)`` first waits for ``result`` (any
    pytree of arrays) with ``jax.block_until_ready``, so the elapsed time
    covers the device work and not only its dispatch."""

    def __init__(self):
        self.elapsed = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0

    def stop(self, result=None):
        if result is not None:
            jax.block_until_ready(result)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed
