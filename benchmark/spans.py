"""The program's own spans (``edgeml_tpu_torch/utils/profiling.py``) read as
per-layer numbers, and a run of one cell that records them:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root runs the harness (``harness.main``, as ``run.py``
does) in this process with span recording on from the window's start to
the end of the traced sub-window (of the window alone under ``--trace 0``),
and prints one line ``{"spans": {...}}`` after the harness's result line:
the readings below, each absent where nothing was recorded for it.
``benchmark/run.py`` is the same run with recording off.
``BENCHMARK.json``'s runs do not call this file.

Program spans over the window, per request root (``serve.batch`` in the
directory mix, a root ``detect`` in the frame mix):
``serve_loader_wait_ms.dir`` (the ``serve.loader_wait`` before each
``serve.batch``), ``loader_busy_ms.dir`` (``load.batch`` on the loader's
threads), ``serve_h2d_ms.dir``, ``serve_detect_ms.dir``,
``serve_d2h_ms.dir``, ``serve_save_ms.dir``, ``serve_covered_pct.dir`` (the
wait and ``serve.batch``'s four children's share of the wait and
``serve.batch``); ``resize_host_ms.frame``
(``prep.*``), ``detect_host_ms.frame``, ``trunk_host_ms.frame``,
``nms_host_ms.frame`` (every ``nms.*`` span, nested time once). Device time
of the traced sub-window by the span that launched it (``by_span``):
``trunk_dev_ms.dir``, ``roi_align_dev_ms.dir``, ``box_head_dev_ms.dir`` a
``serve.batch``; ``detect_kernel_pct.dir`` (kernel time launched under
``detect`` over all kernel time); ``launches.frame``, kernels a ``detect``.
The line also carries, per request root, every span's host ms (total and
self, ``host_ms``) and its device ms and kernels (``device_ms``,
``kernels``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.trace import DEVICE_CATS, WINDOW, _union  # noqa: E402

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SERVE_CHILDREN = ("serve.h2d", "detect", "serve.d2h", "serve.save")


def by_span(events) -> dict:
    """Device time by the annotation that launched it, over the traced
    window of a Chrome trace's ``events``: for each ``user_annotation`` name
    on the window's thread, its call count and the device seconds and
    kernel count of the device operations whose launch (a CUDA runtime or
    driver call on that thread, joined by correlation id) lies inside one
    of its calls; nested annotations each count what they enclose.
    Returns {"kernel_s": all kernel time of the window, "spans": {...}}."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no window annotation")
    w0, w1, tid = win[0]["ts"], win[0]["ts"] + win[0]["dur"], win[0]["tid"]
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


def _ms_per(total_ns, n):
    return total_ns / 1e6 / n if n else None


def readings(recs, traced=None) -> dict:
    """The numbers the module docstring lists, from span records ``recs``
    (``profiling.records()`` of the window) and ``traced`` (``by_span`` of
    the traced sub-window, or None)."""
    ids = {r.id: r for r in recs}
    dur = defaultdict(int)
    for r in recs:
        dur[r.name] += r.end_ns - r.start_ns
    out = {}
    batches = [r for r in recs if r.name == "serve.batch"]
    if batches:
        n = len(batches)
        batch_ids = {r.id for r in batches}
        child = {name: sum(r.end_ns - r.start_ns for r in recs
                           if r.name == name and r.parent in batch_ids)
                 for name in SERVE_CHILDREN}
        wait = dur["serve.loader_wait"]
        out["serve_loader_wait_ms.dir"] = _ms_per(wait, n)
        for key, name in (("serve_h2d_ms", "serve.h2d"), ("serve_detect_ms", "detect"),
                          ("serve_d2h_ms", "serve.d2h"), ("serve_save_ms", "serve.save")):
            out[key + ".dir"] = _ms_per(child[name], n)
        out["loader_busy_ms.dir"] = _ms_per(dur["load.batch"], n)
        out["serve_covered_pct.dir"] = \
            100.0 * (wait + sum(child.values())) / (wait + dur["serve.batch"])
    roots = [r for r in recs if r.name == "detect" and r.parent is None]
    if roots:
        n = len(roots)
        root_ids = {r.id for r in roots}
        out["resize_host_ms.frame"] = _ms_per(dur["prep.letterbox"] + dur["prep.square"], n)
        out["detect_host_ms.frame"] = _ms_per(sum(r.end_ns - r.start_ns for r in roots), n)
        out["trunk_host_ms.frame"] = _ms_per(sum(
            r.end_ns - r.start_ns for r in recs
            if r.name == "detect.trunk" and r.parent in root_ids), n)
        # an nms.* span inside another counts once, in the outer one
        out["nms_host_ms.frame"] = _ms_per(sum(
            r.end_ns - r.start_ns for r in recs if r.name.startswith("nms.")
            and not (r.parent in ids and ids[r.parent].name.startswith("nms."))), n)
    if traced is not None:
        sp = traced["spans"]
        if "serve.batch" in sp:
            n = sp["serve.batch"]["count"]
            for key, name in (("trunk_dev_ms.dir", "detect.trunk"),
                              ("roi_align_dev_ms.dir", "detect.roi_align"),
                              ("box_head_dev_ms.dir", "detect.box_head")):
                if name in sp:
                    out[key] = sp[name]["device_s"] * 1e3 / n
            if "detect" in sp and traced["kernel_s"] > 0:
                out["detect_kernel_pct.dir"] = \
                    100.0 * sp["detect"]["kernel_s"] / traced["kernel_s"]
        elif "detect" in sp:
            out["launches.frame"] = sp["detect"]["kernels"] / sp["detect"]["count"]
    return {k: v for k, v in out.items() if v is not None}


def per_request(recs, traced=None) -> dict:
    """Every span's mean host ms (total and self) and, from ``traced``, its
    device ms and kernels, per request root (``serve.batch``, else a root
    ``detect``): the breakdown behind the readings."""
    from edgeml_tpu_torch.utils.profiling import summary

    out = {}
    summ = summary(recs)
    root = "serve.batch" if "serve.batch" in summ else "detect"
    n = sum(1 for r in recs if r.name == root and r.parent is None)
    if n:
        out["host_ms"] = {k: [v["total_s"] * 1e3 / n, v["self_s"] * 1e3 / n]
                          for k, v in sorted(summ.items())}
    sp = (traced or {}).get("spans", {})
    root = "serve.batch" if "serve.batch" in sp else "detect"
    if root in sp:
        n = sp[root]["count"]
        out["device_ms"] = {k: v["device_s"] * 1e3 / n for k, v in sorted(sp.items())}
        out["kernels"] = {k: v["kernels"] / n for k, v in sorted(sp.items())}
    return out


def main(argv=None, device=None) -> int:
    """One harness run with span recording (see the module docstring);
    ``device`` as ``harness.main``'s."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args, rest = ap.parse_known_args(argv)
    rest += ["--trace", str(args.trace)]
    import benchmark.run  # noqa: F401  (the harness's cache paths, as run.py sets them)
    from benchmark import harness, trace
    from edgeml_tpu_torch.utils import profiling

    got = {}
    orig_init, orig_summarize = harness.Run.__init__, trace.summarize

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        gen = self.generator
        window, traced = gen.window, gen.traced

        def recorded_window(seconds):
            profiling.reset()
            profiling.enable()
            try:
                return window(seconds)
            finally:
                got["window"] = profiling.records()
                profiling.reset()
                profiling.enable(bool(args.trace))

        def recorded_traced():
            try:
                return traced()
            finally:
                profiling.enable(False)

        gen.window, gen.traced = recorded_window, recorded_traced

    def summarize(t, scratch_dir):
        path = os.path.join(scratch_dir, "spans_trace.json")
        t.prof.export_chrome_trace(path)
        with open(path) as f:
            got["traced"] = by_span(json.load(f)["traceEvents"])
        # a profile exports once: the harness's reduction reads this file
        t.prof.export_chrome_trace = lambda to: os.replace(path, to)
        return orig_summarize(t, scratch_dir)

    harness.Run.__init__, trace.summarize = init, summarize
    try:
        rc = harness.main(rest, device=device)
    finally:
        harness.Run.__init__, trace.summarize = orig_init, orig_summarize
        profiling.enable(False)
        profiling.reset()
    if rc == 0:
        recs, traced = got.get("window", []), got.get("traced")
        print(json.dumps({"spans": readings(recs, traced), **per_request(recs, traced)}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
