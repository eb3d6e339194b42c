"""``utils/profiling.py``: ``Span`` as the JAX package's (the same counts and
totals on the same regions, each entry timed on its own), and the serving
path's ``span``: a shared no-op while recording is off; names, nesting,
request ids, counts and self times while it is on, from several threads;
``record_function`` annotations on the calling thread under
``torch.profiler``; the stages that ``run_detection``, ``detect_batch`` and
``FasterRCNN.detect`` record; detection files unchanged by recording."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from edgeml_tpu.utils.profiling import Span as JaxSpan
from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN
from edgeml_tpu_torch.models.infer import _detect_generic, detect_batch, \
    run_detection
from edgeml_tpu_torch.models.retinanet import RetinaNet
from edgeml_tpu_torch.models.ssdlite import SSDLite
from edgeml_tpu_torch.models.yolov5 import YoloV5
from edgeml_tpu_torch.utils import profiling
from edgeml_tpu_torch.utils.profiling import Span, span

torch.set_num_threads(1)

SERVE_CHILDREN = ("serve.h2d", "detect", "serve.d2h", "serve.save")
RCNN_STAGES = ("detect", "detect.trunk", "detect.proposals",
               "detect.roi_align", "detect.box_head", "detect.postprocess")


@pytest.fixture
def recording():
    """Span recording on and empty for the test, off and empty after it."""
    profiling.reset()
    profiling.enable()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def small_yolo():
    return YoloV5(num_classes=8, img_size=64,
                  generator=torch.Generator().manual_seed(1)).eval()


def yolo_batch(b=2):
    px = torch.from_numpy(np.random.default_rng(3).random((b, 64, 64, 3))
                          .astype(np.float32))
    return px, torch.tensor([[1.0, 0.0, 0.0]] * b), \
        torch.tensor([[64.0, 64.0]] * b)


def write_images(img_dir, n=5):
    img_dir.mkdir()
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(50, 70), (64, 40), (33, 90), (64, 64),
                                (120, 96)][:n]):
        np.save(img_dir / f"im{i}.npy", rng.random((h, w, 3))
                .astype(np.float32))


def test_span_accumulates_like_jax():
    spans = [Span("work"), JaxSpan("work")]
    for _ in range(3):
        for s in spans:
            with s:
                time.sleep(0.002)
    for s in spans:
        assert s.count == 3 and s.total >= 0.006
        assert s.mean == pytest.approx(s.total / 3)
    assert repr(spans[0]).startswith("Span(work: total=")
    assert repr(spans[0]).split(":")[0] == repr(spans[1]).split(":")[0]
    empty = Span()
    assert empty.mean == 0.0 and empty.count == 0
    with pytest.raises(ValueError):
        with empty:
            raise ValueError("the span still closes")
    assert empty.count == 1


def test_span_nested_entries_each_add_their_own_time():
    """Re-entered inside itself, a Span adds the outer region and the inner
    one: 0.03 s outside the inner entry plus twice the inner 0.02 s."""
    s = Span("nested")
    with s:
        time.sleep(0.03)
        with s:
            time.sleep(0.02)
    assert s.count == 2
    assert 0.07 <= s.total < 0.07 + 0.05


def test_span_concurrent_entries_add_up():
    """Four threads in one Span at once: each entry counts its own start,
    so the total is four sleeps, not one thread's."""
    s = Span("threads")
    barrier = threading.Barrier(4)

    def work():
        barrier.wait(timeout=10)
        with s:
            time.sleep(0.05)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert s.count == 4 and s.total >= 0.2


def test_off_span_is_one_shared_noop():
    assert span("a") is span("b") is span("detect")
    with span("detect"):
        pass
    assert profiling.records() == [] and profiling.summary() == {}


def test_off_detect_batch_leaves_no_annotation_in_a_profiler_trace():
    net = small_yolo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detect_batch(net, *yolo_batch(), 1e-6, 0.6)
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)
    program = {n for n in names
               if n.split(".")[0] in ("detect", "nms", "prep", "serve",
                                      "load")}
    assert program == set()


def test_on_counts_total_and_self_time_by_name(recording):
    for _ in range(2):
        with span("outer"):
            time.sleep(0.01)
            with span("inner"):
                time.sleep(0.02)
    s = profiling.summary()
    assert s["outer"]["count"] == 2 and s["inner"]["count"] == 2
    assert s["inner"]["total_s"] >= 0.04
    assert s["inner"]["self_s"] == pytest.approx(s["inner"]["total_s"])
    assert s["outer"]["total_s"] >= 0.06
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - s["inner"]["total_s"])
    assert 0.02 <= s["outer"]["self_s"] < s["inner"]["total_s"]


def test_on_nesting_and_request_ids(recording):
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            pass
    with span("e"):
        pass
    r = {k: v[0] for k, v in by_name(profiling.records()).items()}
    assert [x.name for x in profiling.records()] == ["c", "b", "d", "a", "e"]
    assert r["a"].parent is None and r["a"].request == r["a"].id
    assert r["b"].parent == r["a"].id and r["d"].parent == r["a"].id
    assert r["c"].parent == r["b"].id
    assert {r[k].request for k in "abcd"} == {r["a"].id}
    assert r["e"].parent is None and r["e"].request == r["e"].id != r["a"].id
    for k in "bcd":
        parent = next(x for x in r.values() if x.id == r[k].parent)
        assert parent.start_ns <= r[k].start_ns <= r[k].end_ns \
            <= parent.end_ns
    profiling.reset()
    assert profiling.records() == []


def test_on_four_threads_record_every_span(recording):
    """4 threads x 500 spans (250 roots, each with one child) under a short
    switch interval: 2000 records, ids unique, each thread's children under
    its own roots."""
    barrier = threading.Barrier(4)

    def work():
        barrier.wait(timeout=10)
        for _ in range(250):
            with span("root"):
                with span("child"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.records()
    assert len(recs) == 2000
    assert len({r.id for r in recs}) == 2000
    roots = {r.id: r for r in recs if r.name == "root"}
    assert len(roots) == 1000 and all(r.parent is None for r in roots.values())
    for c in (r for r in recs if r.name == "child"):
        root = roots[c.parent]
        assert c.request == root.id and c.thread == root.thread
    assert profiling.summary()["child"]["count"] == 1000


def test_on_spans_are_annotations_on_the_calling_thread(recording, tmp_path):
    net = small_yolo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detect_batch(net, *yolo_batch(), 1e-6, 0.6)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], set()).add(e["tid"])
    want = ("detect", "detect.trunk", "detect.tail", "nms.candidates",
            "nms.suppress", "nms.emit")
    for name in want:
        assert ann.get(name) == {threading.get_native_id()}, (name, ann)
    # the tail's operators run inside the tail's annotation
    tail = next(e for e in events if e.get("name") == "detect.tail")
    inside = [e for e in events if e.get("cat") == "cpu_op"
              and tail["ts"] <= e["ts"] <= tail["ts"] + tail["dur"]]
    assert any(e["name"] == "aten::sort" for e in inside)
    assert set(by_name(profiling.records())) == set(want)


def test_run_detection_records_each_stage_once_a_batch(recording, tmp_path):
    """5 images at batch 2: three ``serve.batch`` requests, each after its
    own ``serve.loader_wait`` and with its four children once, and one last
    wait that finds the loader done; the loader's decodes and builds on
    worker threads, each its own request, a build holding the letterbox;
    the tail's NMS spans under ``detect``."""
    write_images(tmp_path / "imgs")
    run_detection(small_yolo(), str(tmp_path / "imgs"), str(tmp_path / "out"),
                  batch_size=2, conf_thres=1e-6, img_size=64, device="cpu")
    recs = profiling.records()
    by = by_name(recs)
    ids = {r.id: r for r in recs}
    batches = by["serve.batch"]
    assert len(batches) == 3
    assert all(b.parent is None for b in batches)
    waits = by["serve.loader_wait"]
    assert len(waits) == 4 and all(w.parent is None for w in waits)
    # the serving thread alternates wait, batch, ..., wait
    serving = sorted(waits + batches, key=lambda r: r.start_ns)
    assert [r.name for r in serving] == \
        ["serve.loader_wait", "serve.batch"] * 3 + ["serve.loader_wait"]
    for name in SERVE_CHILDREN:
        assert sorted(ids[r.parent].id for r in by[name]) == \
            sorted(b.id for b in batches), name
    for name in ("detect.trunk", "detect.tail"):
        assert [ids[r.parent].name for r in by[name]] == ["detect"] * 3
    for name in ("nms.candidates", "nms.suppress", "nms.emit"):
        assert [ids[r.parent].name for r in by[name]] == ["detect.tail"] * 3
    loads = by["load.batch"]
    assert len(loads) == 3 and all(r.parent is None for r in loads)
    assert {r.thread for r in loads}.isdisjoint({b.thread for b in batches})
    assert sorted(ids[r.parent].id for r in by["prep.letterbox"]) == \
        sorted(r.id for r in loads)
    # each image decodes in a request of its own on the loader's threads,
    # before its batch is prepared
    decodes = by["load.decode"]
    assert len(decodes) == 5 and all(r.parent is None for r in decodes)
    assert {r.thread for r in decodes}.isdisjoint({b.thread for b in batches})
    assert sorted(r.end_ns for r in decodes)[1] <= \
        min(r.start_ns for r in loads)
    assert set(by) == {"serve.batch", "serve.loader_wait", *SERVE_CHILDREN,
                       "detect.trunk", "detect.tail", "nms.candidates",
                       "nms.suppress", "nms.emit", "load.batch",
                       "load.decode", "prep.letterbox"}
    s = profiling.summary()
    children = sum(s[n]["total_s"] for n in SERVE_CHILDREN)
    assert children <= s["serve.batch"]["total_s"]


def test_run_detection_raises_a_failed_write(tmp_path, monkeypatch):
    """A batch's files are written on a writer thread while the next batch
    is served: a write that fails raises from ``run_detection``, and the
    files of the batches before it are on disk."""
    write_images(tmp_path / "imgs")
    real = np.save

    def save(path, rows):
        if os.path.basename(str(path)) == "im4.npy":  # the third batch
            raise OSError("disk full")
        real(path, rows)

    monkeypatch.setattr(np, "save", save)
    with pytest.raises(OSError, match="disk full"):
        run_detection(small_yolo(), str(tmp_path / "imgs"),
                      str(tmp_path / "out"), batch_size=2, conf_thres=1e-6,
                      img_size=64, device="cpu")
    assert sorted(os.listdir(tmp_path / "out")) == \
        [f"im{i}.npy" for i in range(4)]


def test_faster_rcnn_detect_records_its_stages(recording):
    torch.manual_seed(0)
    net = FasterRCNN(num_classes=6, image_size=64, rpn_post_nms=32,
                     detections_per_img=8).eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    _detect_generic(net, x, 0.05, 0.5)
    recs = profiling.records()
    by = by_name(recs)
    ids = {r.id: r for r in recs}
    for name in RCNN_STAGES:
        assert len(by[name]) == 1, name
    root = by["detect"][0]
    assert root.parent is None
    for name in RCNN_STAGES[1:]:
        assert by[name][0].parent == root.id
    starts = [by[n][0].start_ns for n in RCNN_STAGES[1:]]
    assert starts == sorted(starts)
    # the RPN's suppressor in the proposals, the final tail in postprocess
    assert sorted(ids[r.parent].name for r in by["nms.suppress"]) == \
        ["detect.postprocess", "detect.proposals"]
    for name in ("nms.candidates", "nms.emit"):
        assert [ids[r.parent].name for r in by[name]] == \
            ["detect.postprocess"]


@pytest.mark.parametrize("family", ["ssdlite", "retinanet"])
def test_single_stage_detectors_record_trunk_and_tail(recording, family):
    torch.manual_seed(0)
    net = (SSDLite(num_classes=5, image_size=160) if family == "ssdlite"
           else RetinaNet(num_classes=7, image_size=128)).eval()
    s = net.image_size
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, s, s, 3)).astype(np.float32))
    _detect_generic(net, x, 0.001, 0.5)
    recs = profiling.records()
    ids = {r.id: r for r in recs}
    parents = {r.name: ids[r.parent].name if r.parent else None
               for r in recs}
    want = {"detect": None, "detect.trunk": "detect",
            "detect.tail": "detect", "nms.candidates": "detect.tail",
            "nms.suppress": "detect.tail", "nms.emit": "detect.tail"}
    if family == "retinanet":
        # the towers in a span of their own; 3,069 anchors take the prefilter
        want.update({"detect.head": "detect", "nms.prefilter": "detect.tail"})
    assert parents == want
    assert len(recs) == len(parents)


@pytest.mark.parametrize("family", ["yolov5", "faster_rcnn"])
def test_detection_files_are_the_same_with_recording_on(tmp_path, family):
    write_images(tmp_path / "imgs", n=3)
    files = []
    for on in (False, True):
        torch.manual_seed(0)
        net = small_yolo() if family == "yolov5" else FasterRCNN(
            num_classes=6, image_size=64, rpn_post_nms=32,
            detections_per_img=8)
        out = tmp_path / f"out{int(on)}"
        profiling.enable(on)
        try:
            run_detection(net, str(tmp_path / "imgs"), str(out),
                          batch_size=2, conf_thres=1e-6, img_size=64,
                          device="cpu")
            n_recorded = len(profiling.records())
        finally:
            profiling.enable(False)
            profiling.reset()
        assert (n_recorded > 0) == on
        files.append({p.name: p.read_bytes() for p in sorted(out.iterdir())})
    assert len(files[0]) == 3 and files[0] == files[1]
