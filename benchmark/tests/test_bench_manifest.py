"""BENCHMARK.json against the rules its entries keep (names, units, keys,
bounds, the window), and every file a cell needs under the benchmark's
folder."""

import json
import os
import re

import pytest

from benchmark import harness

M = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_and_entry_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    for section, keys in KEYS.items():
        for e in M[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (section, e["name"])
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in M[section]]
    assert len(set(names)) == len(names)
    for e in M[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)


def test_per_layer_moves_a_metric_of_every_cell_it_lists():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    layers = {}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert harness.reports(target, w), (m["name"], w)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"] if harness.reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(harness.reports(m, w["name"]) for m in M["per_layer"]), w["name"]


def test_bounds_and_window():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits 43200 s
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_share_and_pairs():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert len(four) <= max(1, len(M["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_named_file_is_under_paths():
    assert M["paths"] == ["benchmark"] and M["command"][1].startswith("benchmark/")
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/") and not c["reduced"]
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert os.path.isfile(os.path.join(harness.HERE, "families", cfg["family"] + ".py"))
    for w in M["workloads"]:
        mix = harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(harness.HERE, "generators", mix["generator"] + ".py"))
        assert os.path.isfile(os.path.join(harness.HERE, "limits", w["name"] + ".json"))
    readers = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
               if f.endswith(".py") and f != "__init__.py"}
    assert readers == {m["name"] for m in M["per_layer"]}
