"""Timing spans: ``Span`` and the serving path's ``span(name)``.

``Span`` accumulates wall time over the regions it wraps, as the JAX
package's does; nothing in the serving path uses it.

``span(name)`` marks a stage of serving: ``run_detection``'s batches
(``serve.*``), the loader's builds (``load.batch``), the host resizes
(``prep.*``), the detector step (``detect``, ``detect.*``) and the NMS tail
(``nms.*``). Recording is off by default, and then ``span`` returns one
shared no-op context: a flag check, no torch call. ``enable()`` turns it on
for the process: each span then keeps its name, start and end
(``time.perf_counter_ns``), its parent and its request id in memory, read
back with ``records()`` or ``summary()``. A span opened with no enclosing
span on its thread starts a new request; nested spans carry their root's
id. While a ``torch.profiler`` session runs, a recorded span also opens
``torch.profiler.record_function(name)``, so the profiler's trace shows it
on the calling thread beside the device work launched inside it. A span
touches no tensor and never waits for the device.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch


class Span:
    """Accumulating wall-time span: `with span: ...`; `.total` in seconds.
    Every entry keeps its own start, so nested and concurrent entries each
    add their own time."""

    def __init__(self, name: str = ""):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._starts = threading.local()
        self._lock = threading.Lock()

    def __enter__(self):
        self._starts.__dict__.setdefault("stack", []).append(
            time.perf_counter())
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._starts.stack.pop()
        with self._lock:
            self.total += dt
            self.count += 1
        return False

    @property
    def mean(self):
        return self.total / max(self.count, 1)

    def __repr__(self):
        return f"Span({self.name}: total={self.total:.4f}s n={self.count})"


class SpanRecord(NamedTuple):
    """One closed span: ids are unique in the process; ``parent`` is None
    for a request's root, whose own id is the ``request``."""

    id: int
    name: str
    parent: int | None
    request: int
    thread: int
    start_ns: int
    end_ns: int


_ON = False
_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_RECORDS: list[SpanRecord] = []
_IDS = itertools.count(1)
_OPEN = threading.local()  # this thread's stack of open spans


class _Recorded:
    __slots__ = ("name", "id", "parent", "request", "start", "annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.id = next(_IDS)  # one C call: atomic under the interpreter lock
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        self.request = top.request if top else self.id
        stack.append(self)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _OPEN.stack.pop()
        rec = SpanRecord(self.id, self.name, self.parent, self.request,
                         threading.get_ident(), self.start, end)
        with _LOCK:
            _RECORDS.append(rec)
        return False


def span(name: str):
    """``with span("detect.trunk"): ...``: a recorded span when recording is
    on, the shared no-op context when it is off."""
    if not _ON:
        return _OFF
    return _Recorded(name)


def enable(on: bool = True) -> None:
    """Turn span recording on (or off) for the process."""
    global _ON
    _ON = bool(on)


def reset() -> None:
    """Forget every recorded span."""
    with _LOCK:
        _RECORDS.clear()


def records() -> list[SpanRecord]:
    """The spans closed since the last ``reset()``, in closing order."""
    with _LOCK:
        return list(_RECORDS)


def summary(recs=None) -> dict:
    """{name: {"count", "total_s", "self_s"}} over ``recs`` (default
    ``records()``): a span's self time is its duration less its children's
    durations."""
    recs = records() if recs is None else recs
    child_ns = defaultdict(int)
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        dur = r.end_ns - r.start_ns
        s["count"] += 1
        s["total_s"] += dur / 1e9
        s["self_s"] += (dur - child_ns[r.id]) / 1e9
    return out
