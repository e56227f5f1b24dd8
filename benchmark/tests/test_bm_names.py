"""BENCHMARK.json against the contract's limits, and every file a cell
needs found by its name."""

import json
import re

import pytest

from bm import harness, paths

BENCH = json.load(open(paths.benchmark_json()))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(_one_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p


def test_names_units_and_texts():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_what_it_must():
    for cell in CELLS:
        c = harness.Cell(cell, BENCH)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        for m in c.per_layer:  # a per-layer metric moves a metric its cells report
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    c = harness.Cell(cell, BENCH)
    config = next(x for x in BENCH["configs"] if x["name"] == c.workload["config"])
    assert paths.config_file(config["name"]).endswith(config["file"])
    for key in config["reduced"]:
        assert key in c.config and key in c.config["reduced"]
    assert {"source", "reduced", "assumed", "guarantees"} <= set(c.config)
    assert c.config["source"] == config["source"] and len(c.config["source"]) <= 200
    assert c.traffic["name"] == c.workload["traffic"]
    for m in c.per_layer:
        read = c.reader(m["name"])
        assert callable(read)


def test_a_missing_file_is_an_error():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "no-such-traffic"
    with pytest.raises(harness.CellError):
        harness.Cell(bench["workloads"][0]["name"], bench)
    with pytest.raises(harness.CellError):
        harness.Cell("no-such-cell", BENCH)


def test_readers_find_nothing_in_an_empty_window():
    window = {"stages": {}, "planner": {}, "fallbacks": {}, "verdict_mismatches": 0,
              "sets_per_job": {"sum": 0.0, "count": 0.0}}
    for cell in CELLS:
        c = harness.Cell(cell, BENCH)
        ctx = harness.Context(c, window, [])
        for m in c.per_layer:
            assert c.reader(m["name"])(ctx) is None
