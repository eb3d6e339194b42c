"""The benchmark's own profiler run and its reduction: device busy time as
the union of device-operation intervals (never a sum of kernel times, which
counts overlapping kernels twice), the device time of the kernels launched
inside ``aten::convolution``, device time by the program's span that
launched it, the device operations that took most time, and the idle gaps
named by what the host thread was doing."""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Traced:
    """``with Traced() as t: ...`` profiles the block (host and device),
    marks it as the traced window, and synchronises before it closes."""

    def __enter__(self):
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.rf = record_function(WINDOW)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.rf.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _launched_under(events, op, tid):
    """Correlation ids of the device operations launched (the CUDA API's
    launch calls on thread ``tid``) inside a host op named ``op``."""
    spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "cpu_op" and e.get("name") == op
                    and e.get("tid") == tid and "dur" in e])
    starts = [a for a, _ in spans]
    out = set()
    for e in events:
        if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= spans[i][1]:
                out.add(e.get("args", {}).get("correlation"))
    out.discard(None)
    return out


def _window(events):
    """(start, end, thread) of the traced window's annotation."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no window annotation")
    return win[0]["ts"], win[0]["ts"] + win[0]["dur"], win[0]["tid"]


def by_span(events) -> dict:
    """Device time by the annotation that launched it, over the traced
    window of a Chrome trace's ``events``: for each ``user_annotation`` name
    on the window's thread, its call count and the device seconds and
    kernel count of the device operations whose launch (a CUDA runtime or
    driver call on that thread, joined by correlation id) lies inside one
    of its calls; nested annotations each count what they enclose.
    Returns {"kernel_s": all kernel time of the window, "spans": {...}}."""
    w0, w1, tid = _window(events)
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
                      and "correlation" in e.get("args", {}))
    starts = [t for t, _ in launches]
    # correlation -> [device us in the window, kernels, kernel us]
    dev = defaultdict(lambda: [0.0, 0, 0.0])
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b <= a:
                continue
            d = dev[e.get("args", {}).get("correlation")]
            d[0] += b - a
            if e["cat"] == "kernel":
                d[1] += 1
                d[2] += b - a
    calls = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("tid") == tid and "dur" in e \
                and e["name"] != WINDOW and w0 <= e["ts"] <= w1:
            calls[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    spans = {}
    for name, ivs in calls.items():
        corr = set()
        for a, b in _union(ivs):
            lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
            corr.update(c for _, c in launches[lo:hi])
        hit = [dev[c] for c in corr if c in dev]
        spans[name] = {"count": len(ivs), "device_s": sum(h[0] for h in hit) / 1e6,
                       "kernels": sum(h[1] for h in hit),
                       "kernel_s": sum(h[2] for h in hit) / 1e6}
    return {"kernel_s": sum(d[2] for d in dev.values()) / 1e6, "spans": spans}


def summarize(traced: Traced, scratch_dir: str) -> dict:
    """busy_s, window_s, conv_s, by_span and the breakdown of a ``Traced``
    block."""
    path = os.path.join(scratch_dir, "trace.json")
    traced.prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    w0, w1, tid = _window(events)
    conv_ids = _launched_under(events, "aten::convolution", tid)
    dev, by_name, conv_us = [], defaultdict(float), 0.0
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                dev.append((a, b))
                by_name[e["name"][:160]] += (b - a) / 1e6
                if e.get("args", {}).get("correlation") in conv_ids:
                    conv_us += b - a
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("tid") == tid
                  and e.get("name") != WINDOW and "dur" in e)
    gap_names = _name_gaps(gaps, host)
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, gap_names):
        idle[name[:160]] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "conv_s": conv_us / 1e6, "by_span": by_span(events),
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in top_idle]}}


def _name_gaps(gaps, host):
    """For each idle gap, the innermost host event of the traced thread
    that spans its midpoint ("host: no torch op" when none does)."""
    # one sweep: host events of one thread nest, so the open events at a
    # time form a stack whose top is the innermost
    names, stack, k = [], [], 0
    for a, b in gaps:  # in time order
        mid = (a + b) / 2
        while k < len(host) and host[k][0] <= mid:
            s, e, n = host[k]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((e, n))
            k += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        names.append(stack[-1][1] if stack else "host: no torch op")
    return names
