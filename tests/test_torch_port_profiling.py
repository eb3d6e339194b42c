"""``utils/profiling.py``: ``Span`` as the JAX package's (the same counts and
totals on the same regions), and ``trace`` on ``torch.profiler``: a Chrome
trace of the region's operators when given a directory, nothing without
one."""

import json
import time

import pytest
import torch

from edgeml_tpu.utils.profiling import Span as JaxSpan
from edgeml_tpu_torch.utils.profiling import Span, trace

torch.set_num_threads(1)


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


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace(str(log_dir)) as prof:
        a = torch.randn(64, 64)
        (a @ a).relu().sum()
    assert prof is not None
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_does_nothing(tmp_path, log_dir,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(log_dir) as prof:
        torch.ones(3).sum()
    assert prof is None
    assert list(tmp_path.iterdir()) == []
