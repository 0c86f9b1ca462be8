"""Tracing / profiling hooks.

The reference's only tracing is manual time.time_ns() spans surfaced as the
``processing_time`` metric (SURVEY.md §5.1).  Kept — plus real device-side
tooling: jax.profiler trace capture (TensorBoard-compatible) and a span timer
whose endpoints can wait for the device (JAX dispatch is asynchronous, so a
span that does not wait measures only the enqueue).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace (open in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SpanTimer:
    """Named wall-clock spans with device-sync'd endpoints.

    spans: {"window": [secs...], "matching": [secs...], ...}
    """

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """``sync`` may be a pytree to wait for at span exit, or a zero-arg
        callable returning one (for outputs produced inside the span)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync() if callable(sync) else sync)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.spans.items():
            arr = np.asarray(xs)
            out[name] = {"count": len(xs), "total_s": float(arr.sum()),
                         "mean_ms": float(arr.mean() * 1e3),
                         "p50_ms": float(np.percentile(arr, 50) * 1e3),
                         "p95_ms": float(np.percentile(arr, 95) * 1e3)}
        return out
