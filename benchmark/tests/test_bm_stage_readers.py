"""The readers of the program's waits and device stages: each reads its
stage's window delta of sum over count, and nothing from a window that
holds only other stages."""

import json

import pytest

from bm import harness, paths

BENCH = json.load(open(paths.benchmark_json()))
STAGE_OF = {
    "lane_wait_s": "lane_wait",
    "dispatch_wait_s": "dispatch_wait",
    "audit_s": "audit",
    "subgroup_s": "bls/plane_subgroup",
    "scalar_mul_s": "bls/scalar_mul",
}
METRICS = [(m["name"], cell) for m in BENCH["per_layer"] if m["name"].split(".")[0] in STAGE_OF
           for cell in m["workloads"]]


def _window(stages: dict) -> dict:
    return {"stages": stages, "planner": {}, "fallbacks": {}, "verdict_mismatches": 0,
            "sets_per_job": {"sum": 0.0, "count": 0.0}}


def test_every_stage_metric_is_declared():
    assert sorted(name for name, _ in METRICS) == sorted([
        "lane_wait_s.att", "dispatch_wait_s.att", "audit_s.att", "subgroup_s.att",
        "subgroup_s.block", "scalar_mul_s.att", "scalar_mul_s.block"])


@pytest.mark.parametrize("name,cell", METRICS)
def test_reader_divides_its_stage_sum_by_its_count(name, cell):
    c = harness.Cell(cell, BENCH)
    read = c.reader(name)
    stage = STAGE_OF[name.split(".")[0]]
    # the stages beside it, dispatch among them, must not leak into the quotient
    window = _window({stage: {"sum_s": 7.5, "count": 3}, "dispatch": {"sum_s": 100.0, "count": 1},
                      "bisect": {"sum_s": 2.0, "count": 8}})
    assert read(harness.Context(c, window, [])) == pytest.approx(2.5)
    others = _window({"dispatch": {"sum_s": 100.0, "count": 1}})
    assert read(harness.Context(c, others, [])) is None
    empty = _window({stage: {"sum_s": 0.0, "count": 0}})
    assert read(harness.Context(c, empty, [])) is None


@pytest.mark.parametrize("name,cell", METRICS)
def test_reader_reads_a_delta_of_two_snapshots(name, cell):
    c = harness.Cell(cell, BENCH)
    stage = STAGE_OF[name.split(".")[0]]
    before = {"stages": {stage: {"sum_s": 1.0, "count": 2}}, "planner": {}, "fallbacks": {},
              "verdict_mismatches": 0, "sets_per_job": {"sum": 0.0, "count": 0.0}}
    after = {"stages": {stage: {"sum_s": 4.0, "count": 6}}, "planner": {}, "fallbacks": {},
             "verdict_mismatches": 0, "sets_per_job": {"sum": 0.0, "count": 0.0}}
    ctx = harness.Context(c, harness.delta(after, before), [])
    assert c.reader(name)(ctx) == pytest.approx(0.75)
