"""Span readings: ``trace.by_span`` on a hand-written Chrome trace (nested
annotations, device operations joined to their launches by correlation id,
another thread's launches left out), ``spans.readings`` from span records,
none without them (a program that records no spans), and whole ``--trace
1`` runs of the harness on the CPU at a tiny size, which record spans."""

import json

import pytest
import torch

from benchmark import harness, spans, trace
from edgeml_tpu_torch.utils.profiling import SpanRecord


def ann(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(ts, corr, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def device(ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": f"op{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


EVENTS = [
    ann(trace.WINDOW, 0, 1000),
    ann("detect", 10, 200), ann("detect.trunk", 20, 50), ann("detect.tail", 100, 100),
    ann("detect", 400, 100), ann("detect.trunk", 410, 40),
    launch(25, 1), launch(30, 2), launch(105, 3), launch(195, 4), launch(420, 5),
    launch(40, 9, tid=2),  # another thread's launch, inside detect.trunk's time
    launch(600, 6),  # outside every span
    device(300, 10, 1), device(310, 20, 2, cat="gpu_memcpy"), device(330, 5, 3),
    device(340, 7, 4), device(450, 30, 5), device(500, 11, 9), device(700, 3, 6),
    device(990, 100, 8),  # only 10 us of it inside the window
]


def test_by_span_joins_launches_to_their_annotations():
    got = trace.by_span(EVENTS)
    sp = got["spans"]
    assert set(sp) == {"detect", "detect.trunk", "detect.tail"}
    assert sp["detect"] == {"count": 2, "device_s": pytest.approx(72e-6), "kernels": 4,
                            "kernel_s": pytest.approx(52e-6)}
    assert sp["detect.trunk"] == {"count": 2, "device_s": pytest.approx(60e-6),
                                  "kernels": 2, "kernel_s": pytest.approx(40e-6)}
    assert sp["detect.tail"] == {"count": 1, "device_s": pytest.approx(12e-6),
                                 "kernels": 2, "kernel_s": pytest.approx(12e-6)}
    # every kernel of the window, whoever launched it, clipped to the window
    assert got["kernel_s"] == pytest.approx((10 + 5 + 7 + 30 + 11 + 3 + 10) * 1e-6)


def test_by_span_needs_the_window():
    with pytest.raises(RuntimeError):
        trace.by_span(EVENTS[1:])


def rec(i, name, parent, request, start, end, thread=1):
    """A span record, its times in ms."""
    return SpanRecord(i, name, parent, request, thread, start * 10**6, end * 10**6)


def test_readings_of_the_directory_loop():
    recs = []
    for b in range(2):  # two batches of 100 ms, 1 ms apart
        o = 1 + b * 101
        root = 10 * b + 1
        recs += [rec(root + 1, "serve.loader_wait", None, root + 1, o, o + 10),
                 rec(root, "serve.batch", None, root, o + 10, o + 100),
                 rec(root + 2, "serve.h2d", root, root, o + 10, o + 15),
                 rec(root + 3, "detect", root, root, o + 15, o + 60),
                 rec(root + 4, "detect.trunk", root + 3, root, o + 15, o + 40),
                 rec(root + 5, "serve.d2h", root, root, o + 60, o + 90),
                 rec(root + 6, "serve.save", root, root, o + 90, o + 98),
                 rec(root + 7, "load.batch", None, root + 7, o, o + 40, thread=2)]
    traced = {"kernel_s": 0.1, "spans": {
        "serve.batch": {"count": 2, "device_s": 0.1, "kernels": 9, "kernel_s": 0.1},
        "detect": {"count": 2, "device_s": 0.097, "kernels": 8, "kernel_s": 0.096},
        "detect.trunk": {"count": 2, "device_s": 0.05, "kernels": 4, "kernel_s": 0.05},
        "detect.box_head": {"count": 2, "device_s": 0.02, "kernels": 2, "kernel_s": 0.02}}}
    got = spans.readings(recs, traced)
    assert got == pytest.approx({
        "serve_h2d_ms.dir": 5, "serve_detect_ms.dir": 45,
        "serve_d2h_ms.dir": 30, "serve_save_ms.dir": 8, "loader_busy_ms.dir": 40,
        "serve_covered_pct.dir": 98, "trunk_dev_ms.dir": 25, "box_head_dev_ms.dir": 10,
        "detect_kernel_pct.dir": 96})


def test_readings_of_frames():
    recs = []
    for f in range(4):  # prep, then detect with the trunk and two NMS spans
        o = f * 50
        recs += [rec(10 * f + 1, "prep.letterbox", None, 10 * f + 1, o, o + 6),
                 rec(10 * f + 2, "detect", None, 10 * f + 2, o + 6, o + 26),
                 rec(10 * f + 3, "detect.trunk", 10 * f + 2, 10 * f + 2, o + 6, o + 14),
                 rec(10 * f + 4, "detect.tail", 10 * f + 2, 10 * f + 2, o + 14, o + 26),
                 rec(10 * f + 5, "nms.candidates", 10 * f + 4, 10 * f + 2, o + 14, o + 18),
                 rec(10 * f + 6, "nms.suppress", 10 * f + 4, 10 * f + 2, o + 18, o + 21)]
    traced = {"kernel_s": 0.01, "spans": {
        "detect": {"count": 2, "device_s": 0.004, "kernels": 300, "kernel_s": 0.003}}}
    assert spans.readings(recs, traced) == pytest.approx({
        "detect_host_ms.frame": 20, "trunk_host_ms.frame": 8, "nms_host_ms.frame": 7,
        "launches.frame": 150})
    # an nms.* span inside another counts once
    inner = rec(99, "nms.emit", 6, 2, 19, 20)
    assert spans.readings(recs + [inner])["nms_host_ms.frame"] == pytest.approx(7)


@pytest.mark.parametrize("traced", [None, {"kernel_s": 0.0, "spans": {}}])
def test_no_readings_without_program_spans(traced):
    assert spans.readings([], traced) == {}


@pytest.mark.parametrize("family,kind", [("yolov5", "frame"), ("faster_rcnn", "dir")])
def test_a_run_with_spans_on_prints_the_readings(tiny_cell, capsys, family, kind):
    from edgeml_tpu_torch.utils import profiling

    cell = tiny_cell(family, kind)
    argv = ["--workload", cell, "--seed", "2147483659", "--seconds", "0.2", "--trace", "1"]
    assert harness.main(argv, device=torch.device("cpu")) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"]
    want = {"frame": {"detect_host_ms.frame", "trunk_host_ms.frame", "nms_host_ms.frame"},
            "dir": {"loader_busy_ms.dir", "serve_h2d_ms.dir", "serve_detect_ms.dir",
                    "serve_d2h_ms.dir", "serve_save_ms.dir"}}[kind]
    got = {k: v["value"] for k, v in result["metrics"].items() if k in want}
    assert set(got) == want and all(v > 0 for v in got.values())
    # recording is off and empty again after the run
    assert profiling.records() == []
    assert profiling.span("detect") is profiling.span("serve.batch")
