"""A whole run on the CPU at a tiny size (the look for a card skipped):
sound, it comes out correct; with the timed path broken underneath, it
comes out not correct: half of a batch left out, and an answer altered
where it is produced. Plus the refusals: no card, no program."""

import functools
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

CELL = harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"][0]["name"]


def run(capsys, workload):
    rc = harness.main(["--workload", workload, "--seed", "2147483659", "--seconds", "0.2",
                       "--trace", "0"], device=torch.device("cpu"))
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def half_batch(monkeypatch, family):
    """The model step serves the first half of each batch and leaves the
    rest without rows."""
    from edgeml_tpu_torch.models import infer

    name = "detect_batch" if family == "yolov5" else "_detect_generic"
    orig = getattr(infer, name)

    @functools.wraps(orig)
    def broken(net, images, *args, **kwargs):
        dets, valid = orig(net, images, *args, **kwargs)
        valid = valid.clone()
        valid[(valid.shape[0] + 1) // 2:] = False
        return dets, valid

    monkeypatch.setattr(infer, name, broken)


def altered_answer(monkeypatch, family):
    """Each image's best row leaves the model step with its confidence
    raised by 0.01."""
    from edgeml_tpu_torch.models import infer

    name = "detect_batch" if family == "yolov5" else "_detect_generic"
    orig = getattr(infer, name)

    @functools.wraps(orig)
    def broken(net, images, *args, **kwargs):
        dets, valid = orig(net, images, *args, **kwargs)
        dets = dets.clone()
        dets[:, 0, 5] += 0.01
        return dets, valid

    monkeypatch.setattr(infer, name, broken)


@pytest.mark.parametrize("family", ["yolov5", "faster_rcnn"])
@pytest.mark.parametrize("kind", ["dir", "frame"])
@pytest.mark.parametrize("fault", [None, "half_batch", "altered_answer"])
def test_run_is_correct_only_when_sound(capsys, monkeypatch, tiny_cell, family, kind, fault):
    if fault == "half_batch" and kind == "frame":
        pytest.skip("a frame is a batch of one: no half to leave out")
    workload = tiny_cell(family, kind)
    if fault:
        {"half_batch": half_batch, "altered_answer": altered_answer}[fault](monkeypatch, family)
    res = run(capsys, workload)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's folder exits
    non-zero and prints no result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "edgeml_tpu_torch" in out.stderr
