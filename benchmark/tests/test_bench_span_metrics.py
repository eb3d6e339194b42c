"""The harness's span metrics: a ``--trace 1`` run records the program's
spans and reports each span metric that ``BENCHMARK.json`` lists for its
cell and no other; a ``--trace 0`` run records nothing and reports only
end-to-end metrics; recording is off and empty after every run, a failing
one too; and the device readings need kernels in the trace (every
reader file and its entry: ``test_bench_manifest.py``)."""

import json

import pytest
import torch

from benchmark import harness, spans, trace
from edgeml_tpu_torch.utils import profiling

M = harness.load_json(harness.ROOT, "BENCHMARK.json")
SEED = ["--seed", "2147483659", "--seconds", "0.2"]
CASES = [("yolov5", "frame"), ("faster_rcnn", "dir")]
# what a CPU run cannot read: its trace holds no kernel, its device no peak
NEEDS_CARD = {"mfu.dir", "mfu.frame", "conv_roofline.dir", "conv_roofline.frame",
              "trunk_dev_ms.dir", "roi_align_dev_ms.dir", "box_head_dev_ms.dir",
              "detect_kernel_pct.dir", "launches.frame"}


def listed(cell, source=None):
    """The per-layer metrics ``BENCHMARK.json`` lists for ``cell``."""
    return {m["name"] for m in M["per_layer"] if harness.reports(m, cell)
            and source in (None, m["source"])}


def recording_is_off():
    return profiling.records() == [] and \
        profiling.span("detect") is profiling.span("serve.batch")


def traced_run(monkeypatch, capsys, cell, device):
    """A ``--trace 1`` run of ``cell``: (result line, the readers' ctx)."""
    seen = {}
    read = harness.read_metric

    def keep(name, ctx):
        seen["ctx"] = ctx
        return read(name, ctx)

    monkeypatch.setattr(harness, "read_metric", keep)
    assert harness.main(["--workload", cell, *SEED, "--trace", "1"], device=device) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), seen["ctx"]


@pytest.mark.parametrize("family,kind", CASES)
def test_a_traced_run_reports_its_cells_span_metrics(monkeypatch, capsys, tiny_cell,
                                                     family, kind):
    cell = tiny_cell(family, kind)
    result, ctx = traced_run(monkeypatch, capsys, cell, torch.device("cpu"))
    assert result["correct"]
    assert set(result["metrics"]) == listed(cell) - NEEDS_CARD
    assert ctx.span_records and listed(cell, "program_span") <= set(ctx.span_readings)
    if kind == "dir":
        assert ctx.span_readings["serve_covered_pct.dir"] >= 95
    assert recording_is_off()


@pytest.mark.parametrize("family,kind", CASES)
def test_an_untraced_run_records_no_span(monkeypatch, capsys, tiny_cell, family, kind):
    cell = tiny_cell(family, kind)
    got = []
    records = profiling.records

    def keep():
        got.append(records())
        return got[-1]

    monkeypatch.setattr(profiling, "records", keep)
    assert harness.main(["--workload", cell, *SEED, "--trace", "0"],
                        device=torch.device("cpu")) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got and all(r == [] for r in got)
    e2e = {m["name"] for m in M["end_to_end"] if harness.reports(m, cell)}
    assert set(result["metrics"]) == e2e
    assert recording_is_off()


def test_recording_is_off_after_a_failing_check(monkeypatch, tiny_cell):
    cell = tiny_cell("yolov5", "frame")

    def fails(run, limits):
        assert recording_is_off()
        raise RuntimeError("the reference check failed")

    monkeypatch.setattr(harness, "check", fails)
    with pytest.raises(RuntimeError, match="reference check failed"):
        harness.main(["--workload", cell, *SEED, "--trace", "1"], device=torch.device("cpu"))
    assert recording_is_off()


def test_device_readings_only_from_a_trace_with_kernels():
    def ann(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}

    events = [ann(trace.WINDOW, 0, 100), ann("serve.batch", 0, 90), ann("detect", 5, 60)]
    for i, (t, inside) in enumerate([(10, True), (20, True), (70, False)]):
        events += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 1,
                    "tid": 1, "args": {"correlation": i}},
                   {"cat": "kernel", "name": f"k{i}", "ts": t + 10, "dur": 5 + 10 * inside,
                    "tid": 7, "args": {"correlation": i}}]
    got = spans.readings([], trace.by_span(events))
    assert got["detect_kernel_pct.dir"] == pytest.approx(100 * 30 / 35)
    assert 0 <= got["detect_kernel_pct.dir"] <= 100
    no_kernels = [e for e in events if e["cat"] != "kernel"]
    assert spans.readings([], trace.by_span(no_kernels)) == {}


@pytest.mark.gpu
@pytest.mark.parametrize("family,kind", CASES)
def test_a_traced_run_on_the_card_reports_every_metric_of_its_cell(
        monkeypatch, capsys, tiny_cell, cuda_device, family, kind):
    cell = tiny_cell(family, kind)
    result, _ = traced_run(monkeypatch, capsys, cell, cuda_device)
    assert result["correct"]
    assert set(result["metrics"]) == listed(cell)
    if kind == "dir":
        assert 0 <= result["metrics"]["detect_kernel_pct.dir"]["value"] <= 100
    assert recording_is_off()

