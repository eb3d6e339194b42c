"""The program's own spans (``edgeml_tpu_torch/utils/profiling.py``) read as
per-layer numbers. A ``--trace 1`` run of the harness records them over its
window and its traced sub-window; ``harness.main`` hands ``readings`` of
them to the readers in ``metrics/`` as ``ctx.span_readings`` (and the
window's records as ``ctx.span_records``), and each reader returns its own
number, or None where the run has none.

Program spans over the window, per request root (``serve.batch`` in the
directory mix, a root ``detect`` in the frame mix): ``loader_busy_ms.dir``
(``load.batch`` on the loader's threads), ``serve_h2d_ms.dir``,
``serve_detect_ms.dir``, ``serve_d2h_ms.dir``, ``serve_save_ms.dir`` (the
four children of ``serve.batch``), ``serve_covered_pct.dir`` (the children
and the ``serve.loader_wait`` before each batch as a share of the wait and
``serve.batch``: a check that the spans cover the batch, read by the tests);
``detect_host_ms.frame``, ``trunk_host_ms.frame``, ``nms_host_ms.frame``
(every ``nms.*`` span, nested time once). Device time of the traced
sub-window by the span that launched it (``trace.by_span``), only where the
sub-window ran kernels: ``trunk_dev_ms.dir``, ``roi_align_dev_ms.dir``,
``box_head_dev_ms.dir`` a ``serve.batch``; ``detect_kernel_pct.dir``
(kernel time launched under ``detect`` over all kernel time);
``launches.frame``, kernels a ``detect``.
"""

from __future__ import annotations

from collections import defaultdict

SERVE_CHILDREN = ("serve.h2d", "detect", "serve.d2h", "serve.save")


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
        for key, name in (("serve_h2d_ms", "serve.h2d"), ("serve_detect_ms", "detect"),
                          ("serve_d2h_ms", "serve.d2h"), ("serve_save_ms", "serve.save")):
            out[key + ".dir"] = _ms_per(child[name], n)
        out["loader_busy_ms.dir"] = _ms_per(dur["load.batch"], n)
        wait = dur["serve.loader_wait"]
        out["serve_covered_pct.dir"] = \
            100.0 * (wait + sum(child.values())) / (wait + dur["serve.batch"])
    roots = [r for r in recs if r.name == "detect" and r.parent is None]
    if roots:
        n = len(roots)
        root_ids = {r.id for r in roots}
        out["detect_host_ms.frame"] = _ms_per(sum(r.end_ns - r.start_ns for r in roots), n)
        out["trunk_host_ms.frame"] = _ms_per(sum(
            r.end_ns - r.start_ns for r in recs
            if r.name == "detect.trunk" and r.parent in root_ids), n)
        # an nms.* span inside another counts once, in the outer one
        out["nms_host_ms.frame"] = _ms_per(sum(
            r.end_ns - r.start_ns for r in recs if r.name.startswith("nms.")
            and not (r.parent in ids and ids[r.parent].name.startswith("nms."))), n)
    if traced is not None and traced["kernel_s"] > 0:
        sp = traced["spans"]
        if "serve.batch" in sp:
            n = sp["serve.batch"]["count"]
            for key, name in (("trunk_dev_ms.dir", "detect.trunk"),
                              ("roi_align_dev_ms.dir", "detect.roi_align"),
                              ("box_head_dev_ms.dir", "detect.box_head")):
                if name in sp:
                    out[key] = sp[name]["device_s"] * 1e3 / n
            if "detect" in sp:
                out["detect_kernel_pct.dir"] = \
                    100.0 * sp["detect"]["kernel_s"] / traced["kernel_s"]
        elif "detect" in sp:
            out["launches.frame"] = sp["detect"]["kernels"] / sp["detect"]["count"]
    return {k: v for k, v in out.items() if v is not None}
