"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds it by."""

from __future__ import annotations

import json
import re

import pytest

from otbench import harness

MAN = harness.load_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_shape():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for w in MAN["command"][1:]:
        assert not w.startswith("/") and ".." not in w
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells, each run allowed run_seconds + 60 s, fits 43,200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["source"] for c in MAN["configs"]}) == len(MAN["configs"])
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in E2E_SOURCES and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] == 0.25
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = harness.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.config["reduced"] == next(x["reduced"] for x in MAN["configs"]
                                       if x["name"] == c.config["name"])
    assert c.traffic["trace_seconds"] <= MAN["run_seconds"]


def test_every_workload_key_names_a_cell():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in MAN["configs"]:
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
