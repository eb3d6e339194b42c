"""The RetinaNet configuration at a tiny size on the CPU (the look for a
card skipped), through the harness with its cell's limits: a sound run comes
out correct and a broken one not; a traced run records the head and the
prefilter as spans of their own, in the program's records and in the
profile; the three readers of those spans; the family's FLOPs and
refusals."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.families import retinanet as family
from benchmark.tests.conftest import MIXES
from benchmark.tests.test_bench_faults import altered_answer, half_batch, run

CELL = "retinanet-r50-fpn-v2-640.dir-b16"
# 128 px: 3,069 anchors, more than the prefilter's 2,048
TINY = {"family": "retinanet", "num_classes": 7, "image_size": 128, "prefilter_top_n": 2048,
        "detections_per_img": 300, "conf_thres": 0.001, "iou_thres": 0.6}


@pytest.fixture
def retina_cell(monkeypatch):
    lim = harness.load_json(harness.HERE, "limits", CELL + ".json")
    monkeypatch.setattr(harness, "cell_spec", lambda name, manifest: (
        {"name": name, "chips": 1}, dict(TINY), dict(MIXES["dir"]), lim))
    return CELL


@pytest.mark.parametrize("fault", [None, "half_batch", "altered_answer"])
def test_run_is_correct_only_when_sound(capsys, monkeypatch, retina_cell, fault):
    if fault:
        {"half_batch": half_batch, "altered_answer": altered_answer}[fault](
            monkeypatch, "retinanet")
    res = run(capsys, retina_cell)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["checks"]["ref_rows"]["value"] >= 1


def traced_run(monkeypatch, capsys, cell, device):
    """A ``--trace 1`` run: (result line, the window's span records, the
    traced pass's device time by span)."""
    from benchmark import spans

    seen = {}
    read = spans.readings

    def keep(recs, by_span):
        seen.update(recs=recs, by_span=by_span)
        return read(recs, by_span)

    monkeypatch.setattr(spans, "readings", keep)
    assert harness.main(["--workload", cell, "--seed", "2147483659", "--seconds", "0.2",
                         "--trace", "1"], device=device) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), seen["recs"], \
        seen["by_span"]


def test_a_traced_run_records_head_and_prefilter(monkeypatch, capsys, retina_cell):
    result, recs, by_span = traced_run(monkeypatch, capsys, retina_cell, torch.device("cpu"))
    assert result["correct"]
    ids = {r.id: r for r in recs}
    parents = {}
    for r in recs:
        parents.setdefault(r.name, set()).add(ids[r.parent].name if r.parent else None)
    assert parents["detect.trunk"] == parents["detect.head"] == {"detect"}
    assert parents["nms.prefilter"] == {"detect.tail"}
    assert {"detect.trunk", "detect.head", "nms.prefilter"} <= set(by_span["spans"])


def trace_of(spans, kernel_s=1.0):
    return {"by_span": {"kernel_s": kernel_s, "spans": {
        name: {"count": c, "device_s": d, "kernels": 1, "kernel_s": d}
        for name, (c, d) in spans.items()}}}


def test_readers_of_head_and_prefilter():
    """Device ms a ``serve.batch`` of ``detect.head`` and ``nms.prefilter``,
    and the head's FLOPs over its device seconds over the f32 peak."""
    ctx = SimpleNamespace(trace=trace_of({"serve.batch": (16, 2.0), "detect.head": (16, 0.9),
                                          "nms.prefilter": (16, 0.008)}),
                          flops_traced={"conv": 3e15, "linear": 0, "head": 2e15},
                          f32_peak=5e16)
    assert harness.read_metric("head_dev_ms.dir", ctx) == pytest.approx(56.25)
    assert harness.read_metric("prefilter_dev_ms.dir", ctx) == pytest.approx(0.5)
    assert harness.read_metric("head_roofline.dir", ctx) == pytest.approx(100 * 2e15 / 0.9 / 5e16)


@pytest.mark.parametrize("ctx", [
    SimpleNamespace(trace=None, flops_traced={"head": 1.0}, f32_peak=1.0),
    SimpleNamespace(trace=trace_of({"serve.batch": (1, 1.0), "detect.head": (1, 1.0),
                                    "nms.prefilter": (1, 1.0)}, kernel_s=0.0),
                    flops_traced={"head": 1.0}, f32_peak=1.0),
    # a program whose head runs inside detect.trunk, and a family with no head
    SimpleNamespace(trace=trace_of({"serve.batch": (1, 1.0), "detect.trunk": (1, 1.0)}),
                    flops_traced={"conv": 1.0, "linear": 0}, f32_peak=1.0),
])
def test_readers_find_nothing_without_the_spans(ctx):
    for name in ("head_dev_ms.dir", "prefilter_dev_ms.dir", "head_roofline.dir"):
        assert harness.read_metric(name, ctx) is None, name


def test_request_flops_count_trunk_and_head_per_image():
    cfg = harness.load_json(harness.HERE, "configs", "retinanet-r50-fpn-v2-640.json")
    f = family.reference.flops(cfg)
    one, three = family.request_flops(None, cfg, [], [[0], [0, 1, 1]], "cpu")
    assert one["head"] == f["head"]["conv"] == 2 * 8525 * 6688512
    assert one["conv"] == f["trunk"]["conv"] + f["head"]["conv"]
    assert one["linear"] == 0
    assert three == {k: 3 * v for k, v in one.items()}


@pytest.mark.parametrize("key,value", [("prefilter_top_n", 1000), ("detections_per_img", 100)])
def test_program_refuses_what_the_port_does_not_serve(key, value):
    with pytest.raises(ValueError, match=key):
        family.program(dict(TINY, **{key: value}), {}, torch.device("cpu"))


@pytest.mark.gpu
def test_on_the_card_head_and_prefilter_launch_their_own_kernels(
        monkeypatch, capsys, retina_cell, cuda_device):
    result, _, by_span = traced_run(monkeypatch, capsys, retina_cell, cuda_device)
    assert result["correct"]
    sp = by_span["spans"]
    for name in ("detect.trunk", "detect.head", "nms.prefilter"):
        assert sp[name]["kernels"] > 0 and sp[name]["device_s"] > 0, name
