"""Timing spans and the profiler hook.

``Span`` accumulates wall time over the regions it wraps, as the CLIs
persist their wall times beside their results. ``trace(log_dir)`` records
``torch.profiler`` (host and, on a CUDA machine, device activity) around a
region and writes a Chrome trace (``trace.json``, viewable in Perfetto or
``chrome://tracing``) into ``log_dir``; without a ``log_dir`` it does
nothing.
"""

from __future__ import annotations

import contextlib
import os
import time


class Span:
    """Accumulating wall-time span: `with span: ...`; `.total` in seconds."""

    def __init__(self, name: str = ""):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self):
        return self.total / max(self.count, 1)

    def __repr__(self):
        return f"Span({self.name}: total={self.total:.4f}s n={self.count})"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` around a region when ``log_dir`` is given (the
    CUDA activity too when a card is present), its Chrome trace written to
    ``{log_dir}/trace.json`` on exit; a no-op otherwise. Yields the
    profiler (None when off). Usage: ``with trace("prof"): step(...)``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
