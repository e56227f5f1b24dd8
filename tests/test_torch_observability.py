"""The port's observability (`lodestar_tpu_torch/observability/`,
`lodestar_tpu_torch/metrics/registry.py`) against the JAX package's, on
the CPU:

- `PipelineMetrics` registers the JAX one's families in the same order,
  with the same names, types, help texts, label names and buckets (the
  build-info gauge's help and first two labels apart: they name the
  port's runtime), covers every family the dashboards and the SLO rules
  read, and renders the same exposition for the same calls;
- the registry, the flight recorder, the compile ledger and the device
  ledger behave as their JAX modules on the same inputs and a fake clock;
  the library builds are compile events, `hit` or `miss` by the build
  directory;
- the stage timer, the profiler switch and the named scopes;
- `TorchBlsVerifier`, `DeviceBlsVerifier` and `EpochPubkeyTable` record
  into `default_pipeline()` when no observer is passed (kernels stubbed);
- `profile_stages` observes the grouped verdict's stages under the JAX
  stage names (one (2, 4) CPU verdict, the only real one of the file).
"""

import glob
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from lodestar_tpu.metrics import registry as jax_registry
from lodestar_tpu.observability import compile_ledger as jax_compile_ledger
from lodestar_tpu.observability import device_ledger as jax_device_ledger
from lodestar_tpu.observability import flight_recorder as jax_flight_recorder
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipelineMetrics
from lodestar_tpu.testing import faults
from lodestar_tpu_torch import build
from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
from lodestar_tpu_torch.metrics import registry
from lodestar_tpu_torch.observability import (
    compile_ledger,
    device_ledger,
    flight_recorder,
    stage_profile,
    trace,
)
from lodestar_tpu_torch.observability.runtime import runtime_info
from lodestar_tpu_torch.observability.stages import (
    BUILD_INFO_LABELS,
    NULL_OBSERVER,
    PipelineMetrics,
    default_pipeline,
)
from lodestar_tpu_torch.parallel import verifier as pv
from lodestar_tpu_torch.parallel.epoch_table import EpochPubkeyTable
from lodestar_tpu_torch.profile_verdict import make_sets

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUILD_INFO = "lodestar_tpu_build_info"


class FakeClock:
    """`time.monotonic` stand-in: moves only when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear(reset_counters=True)
    yield
    faults.clear(reset_counters=True)


# --- the families --------------------------------------------------------------


def _families(pm):
    out = []
    for m in pm.registry._metrics:
        help_, labels = m.help, m.label_names
        if m.name == BUILD_INFO:  # the port's runtime: torch, CUDA
            help_, labels = None, labels[2:]
        out.append((m.name, m.kind, help_, labels, getattr(m, "buckets", None)))
    return out


def test_families_equal_the_jax_pipelines():
    ours, theirs = PipelineMetrics(), JaxPipelineMetrics()
    assert _families(ours) == _families(theirs)
    assert BUILD_INFO_LABELS[2:] == ("backend", "device_kind", "device_count",
                                     "mesh_divisor", "compile_cache")
    public = lambda cls: sorted(n for n in dir(cls) if not n.startswith("_"))  # noqa: E731
    assert public(PipelineMetrics) == public(JaxPipelineMetrics)


def test_every_dashboard_family_is_registered():
    theirs = {m.name for m in JaxPipelineMetrics().registry._metrics}
    ours = {m.name for m in PipelineMetrics().registry._metrics}
    read = set()
    for name in ("lodestar_tpu_bls_verifier.json", "lodestar_tpu_summary.json",
                 "slo_rules.json"):
        with open(os.path.join(REPO, "dashboards", name)) as f:
            text = f.read()
        for fam in re.findall(r"lodestar_(?:bls|tpu|slo)_[A-Za-z0-9_]+", text):
            read.add(re.sub(r"_(bucket|sum|count)$", "", fam))
    wanted = read & theirs
    assert len(wanted) > 40  # the stage, planner, supervisor, lane, ledger and SLO families
    assert wanted <= ours


def _drive(pm, clock: FakeClock) -> list:
    """One call of every recording method, then every snapshot."""
    with pm.stage("marshal"):
        clock.advance(0.25)
    pm.observe_stage("device_wait", 0.003)
    pm.planner("root_grouped", 128, group_sizes=[8] * 16)
    pm.planner("individual", 3)
    pm.cache_event("h2c", True, n=5)
    pm.cache_event("pk", False, n=2)
    pm.cache_event("pk", True, n=0)
    pm.epoch_table_event(True, n=128)
    pm.epoch_table_event(False, n=0)
    pm.epoch_table_occupancy(128)
    pm.epoch_table_eviction(4)
    pm.h2c_dedup(3)
    pm.bisect(rounds=0, probes=0)
    pm.bisect(rounds=7, probes=36)
    pm.decompress_fallback()
    pm.breaker_state(1, to="half_open")
    pm.breaker_state(0)
    pm.supervisor_retry()
    pm.supervisor_fallback("exception", n_sets=4)
    pm.supervisor_fallback("negative_audit")
    pm.supervisor_deadline()
    pm.supervisor_canary_probe(True)
    pm.both_tiers_failed()
    pm.verdict_mismatch(2)
    pm.waiter_timeout()
    pm.mesh_state(4, 1)
    pm.mesh_eviction(3, "deadline")
    pm.mesh_readmission()
    pm.mesh_dispatch([0, 1, 2])
    pm.fleet_state(2, 0)
    pm.fleet_dispatch([0, 1])
    pm.fleet_dcn_seconds(0.5)
    pm.fleet_host_eviction(1, "exception")
    pm.fleet_rebalance(12)
    pm.bind_lane_depths(lambda: {"depths": {"block": 0}})
    pm.lane_depth_set("attestation", 64)
    pm.lane_shed("attestation", 5)
    pm.lane_coalesce(96)
    pm.lane_overlap(True)
    pm.lane_overlap(False)
    pm.compile_event("grouped_raw", "miss", 12.5, cumulative_s=12.5)
    pm.aot_event("grouped_raw", "miss")
    pm.cache_pruned(1024, 7)
    pm.startup_phase("devices_ready", 1.5)
    pm.serving_ready(9.25)
    pm.set_build_info({"backend": "cuda", "device_kind": "H100", "device_count": "1"})
    pm.slo_report("verify_latency", True, 0.5, 14.4, 6.0)
    pm.slo_evaluated()
    pm.device_dispatch_time("attestation", "grouped", "0", 0.75, 0.25)
    pm.device_idle(3.5)
    pm.device_memory_sample("0", "in_use", 4096)
    pm.device_memory_watermark_set("0", 8192)
    pm.bind_buffer_depth(lambda: 17)
    pm.flush("size", latency_s=0.04)
    pm.flush("timer")
    pm.device_busy_sample(0.3)
    clock.advance(2.0)
    pm.device_busy_sample(0.9)  # closes a >= 1 s window: the gauge moves
    return [pm.stage_snapshot(), pm.planner_snapshot(), pm.bisect_snapshot(),
            pm.mesh_snapshot(), pm.fleet_snapshot(), pm.lanes_snapshot()]


def _without_build_info(text: str) -> list:
    return [ln for ln in text.splitlines() if BUILD_INFO not in ln]


def test_same_calls_same_exposition(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    theirs = JaxPipelineMetrics()
    snaps_theirs = _drive(theirs, clock)
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    ours = PipelineMetrics()
    snaps_ours = _drive(ours, clock)
    assert snaps_ours == snaps_theirs
    assert _without_build_info(ours.registry.expose()) == \
        _without_build_info(theirs.registry.expose())
    assert 'lodestar_tpu_build_info{backend="cuda",compile_cache="unknown",cuda="unknown",' \
        in ours.registry.expose()
    # the fault plan: the JAX pipeline reads the global module, the port's
    # the object it was given (none: nothing armed)
    assert ours.supervisor_snapshot() == theirs.supervisor_snapshot()
    assert ours.supervisor_snapshot()["faults"] == {"active": False, "modes": {},
                                                    "injected": {}}
    faults.configure("flaky:0.5")
    faults.flaky_verdict(True)
    armed = PipelineMetrics(faults=faults)
    _drive(armed, FakeClock())
    snap = armed.supervisor_snapshot()
    assert snap == theirs.supervisor_snapshot()
    assert snap["faults"]["active"] and snap["degraded"]


def test_registry_renders_as_the_jax_registry():
    def fill(mod):
        r = mod.MetricsRegistry(prefix="p_")
        c = r.counter("c_total", "a counter", label_names=("path", "kind"))
        g = r.gauge("g", "a gauge", label_names=("chip",))
        h = r.histogram("h_seconds", "a histogram", label_names=("stage",),
                        buckets=(0.1, 1, 10))
        d = r.histogram("d_seconds", "default buckets")
        s = r.summary("s_seconds", "a summary", label_names=("lane",))
        r.gauge_func("f", "a callback gauge", fn=lambda: 3)
        r.gauge_func("broken", "a failing callback", fn=lambda: 1 / 0)
        c.inc(path="a", kind="x")
        c.inc(2.5, path="b", kind="y")
        g.set(7, chip="1")
        g.set(-1, chip="0")
        for v in (0.05, 0.5, 5, 50):
            h.observe(v, stage="miller_loop")
        h.observe(0.2, stage="final_exp")
        d.observe(0.002)
        s.observe(1.5, lane="block")
        s.observe(0.5, lane="block")
        with pytest.raises(ValueError):
            c.inc(path="a")
        return r, c, s

    ours, c_ours, s_ours = fill(registry)
    theirs, c_theirs, s_theirs = fill(jax_registry)
    assert ours.expose() == theirs.expose()
    assert c_ours.value(path="b", kind="y") == c_theirs.value(path="b", kind="y") == 2.5
    assert (s_ours.sum(lane="block"), s_ours.count(lane="block")) == (2.0, 2)


# --- flight recorder, compile ledger, device ledger ------------------------------


def _without_times(dump):
    return {**dump, "events": [{k: v for k, v in e.items() if k != "t_s"}
                               for e in dump["events"]]}


def test_flight_recorder_ring_equals_the_jax_ring():
    dumps = []
    for mod in (flight_recorder, jax_flight_recorder):
        assert mod.FlightRecorder().capacity == 256
        rec = mod.FlightRecorder(capacity=3)
        for i in range(5):
            assert rec.record("dispatch", path="grouped", sets=i)["seq"] == i + 1
        dumps.append(_without_times(rec.dump()))
        assert rec.dump(limit=1)["dropped"] == 4
    assert dumps[0] == dumps[1]
    assert dumps[0]["dropped"] == 2
    assert [e["sets"] for e in dumps[0]["events"]] == [2, 3, 4]


def test_wrap_times_the_first_call_per_kernel_and_shape(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "absent"))
    events = []
    for mod in (compile_ledger, jax_compile_ledger):
        clock = FakeClock()
        monkeypatch.setattr(time, "monotonic", clock)
        led = mod.CompileLedger()
        calls = []

        def kernel(x, flag=None, _calls=calls, _clock=clock):
            _calls.append(x.shape)
            _clock.advance(1.25)  # only the call itself takes time
            return x.sum()

        f = led.wrap(kernel, "grouped_raw")
        g = led.wrap(kernel, "bisect_probe", static_key="16")
        a, b = np.zeros((2, 3), np.int32), np.zeros((4, 3), np.int32)
        f(a), f(a), f(b), f(a, flag=True), g(a), g(b)
        assert len(calls) == 6  # every call goes through
        assert f.__compile_ledger_kernel__ == "grouped_raw"
        events.append([{k: e[k] for k in ("kernel", "key", "seconds")}
                       for e in led.snapshot()["events"]])
    assert events[0] == events[1]
    assert [e["key"] for e in events[0]] == [
        "int32[2x3]", "int32[4x3]", "int32[2x3],bool", "16"]
    assert all(e["seconds"] == 1.25 for e in events[0])


def test_builds_and_first_calls_classified_by_the_build_directory(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "probe.c").write_text("int probe(void) { return 7; }\n")
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    pm = PipelineMetrics()
    cc = build.find_compiler("cc", "gcc", "clang")
    flags = ["-O0", "-shared", "-fPIC"]
    led = compile_ledger.ledger()
    seen = len(led.snapshot()["events"])
    first = build.build_shared("probe", cc, flags, ["probe.c"])
    again = build.build_shared("probe", cc, flags, ["probe.c"])
    assert first == again and os.path.exists(first)
    mine = [e for e in led.snapshot()["events"][seen:] if e["kernel"] == "build/probe"]
    assert [e["cache"] for e in mine] == ["miss", "hit"]
    assert mine[0]["key"] == os.path.basename(first)[len("libprobe-"):-len(".so")]
    assert pm.compile_events.value(kernel="build/probe", cache="miss") == 1
    assert pm.compile_events.value(kernel="build/probe", cache="hit") == 1
    kinds = [(e["kind"], e.get("kernel")) for e in flight_recorder.recorder().dump()["events"]]
    assert ("compile_start", "build/probe") in kinds

    # a verdict's first call: miss when a library appeared, hit when not,
    # off without a build directory
    own = compile_ledger.CompileLedger()
    grew = own.wrap(lambda: (tmp_path / "build" / "libnew.so").write_bytes(b""), "grew")
    same = own.wrap(lambda: None, "same")
    grew(), same()
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "absent"))
    own.wrap(lambda: None, "none")()
    snap = own.snapshot()
    assert [(e["kernel"], e["cache"]) for e in snap["events"]] == [
        ("grew", "miss"), ("same", "hit"), ("none", "off")]
    assert snap["cache"]["state"] == "off" and snap["aot"]["events"] == []
    out = own.write_artifact(str(tmp_path / "compile_ledger.json"))
    with open(out) as f:
        assert json.load(f)["event_count"] == 3


def _drive_ledger(mod, clock):
    stats = {"0": {"in_use": 4096, "peak": 8192, "limit": 1 << 30, "live_buffers": 6144}}
    led = mod.DeviceLedger(clock=clock, memory_stats_fn=lambda: stats)
    with led.lane_flush("block"):
        clock.advance(0.5)
        with led.dispatch("grouped", [0, 1]):
            clock.advance(1.0)
    clock.advance(2.0)  # idle
    with led.lane_flush("attestation", overlapped=True):
        clock.advance(0.25)  # no inner dispatch: the flush is attributed
    with led.dispatch("bisect", [0]):
        clock.advance(0.5)
        with led.dispatch("probe", [0]):  # began while another was in flight
            clock.advance(0.125)
    led.sample_memory(force=True)
    return led.snapshot()


def test_device_ledger_equals_the_jax_ledger():
    ours = _drive_ledger(device_ledger, FakeClock())
    theirs = _drive_ledger(jax_device_ledger, FakeClock())
    assert ours == theirs
    assert ours["busy_wall_s"] == 2.375 and ours["idle_wall_s"] == 2.0
    assert ours["memory"]["0"]["watermark_bytes"] == 4096
    overlap = {(r["kernel"], r["chip"]): r["overlap_s"] for r in ours["attributed"]}
    assert overlap[("lane_flush", "0")] == 0.25 and overlap[("bisect", "0")] == 0.625


def test_memory_sampler_without_cuda_reports_nothing():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the reader reports its memory")
    assert device_ledger._default_memory_stats() == {}
    led = device_ledger.DeviceLedger()
    led.sample_memory(force=True)
    snap = led.snapshot()
    assert snap["memory"] == {} and snap["memory_samples"] == 1


# --- stage timer, profiler switch, scopes ----------------------------------------


def test_stage_timer_observes_elapsed_seconds(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    pm = PipelineMetrics()
    with pm.stage("marshal") as timer:
        assert timer.bound(torch.ones(3)) is not None  # a CPU tensor: no wait
        clock.advance(0.5)
    with pm.stage("marshal") as timer:
        timer.bound((torch.ones(2), [torch.zeros(1)]))
        clock.advance(0.25)
    assert timer.elapsed == 0.25
    assert pm.stage_snapshot() == {"marshal": {"sum_s": 0.75, "count": 2}}


def test_profiler_switch_and_named_scopes(tmp_path):
    assert not trace.profiling_active()
    assert trace.stop_profiling() is None
    assert trace.start_profiling(str(tmp_path)) == str(tmp_path)
    try:
        assert trace.start_profiling(str(tmp_path / "other")) is None
        assert trace.profiling_active()
        x = torch.arange(8)
        with trace.named_scope("bls/miller_loop"):
            x = x * 2
        with trace.annotation("bls_verify_batch/8"):
            x = x + 1
    finally:
        stopped = trace.stop_profiling()
    assert stopped == str(tmp_path) and not trace.profiling_active()
    files = glob.glob(os.path.join(stopped, "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"bls/miller_loop", "bls_verify_batch/8"} <= names
    assert not (tmp_path / "other").exists()


def test_runtime_identity_fills_the_build_info_labels():
    info = runtime_info()
    assert tuple(sorted(info)) == tuple(sorted(BUILD_INFO_LABELS))
    assert info["torch"] == torch.__version__ and info["mesh_divisor"] == "1"
    assert info["compile_cache"] == build.BUILD_DIR
    pm = PipelineMetrics()
    pm.set_build_info(info)
    assert [v for _, v in pm.build_info.collect()] == [1.0]


# --- the default observer ----------------------------------------------------------


def test_default_observer_is_the_default_pipeline(monkeypatch):
    pm = default_pipeline()
    assert pv.TorchBlsVerifier(device="cpu").observer is pm
    facade = DeviceBlsVerifier(device="cpu", grouped_configs=((2, 4),))
    assert facade.observer is pm and facade._inner._epoch_table.observer is pm
    assert EpochPubkeyTable(device="cpu").observer is pm
    assert DeviceBlsVerifier(device="cpu", observer=NULL_OBSERVER).observer is NULL_OBSERVER

    # one verdict with the kernel stubbed: every family of the path moves
    monkeypatch.setattr(pv, "grouped_verify_kernel_raw", lambda *a, **kw: torch.tensor(True))
    sets = make_sets(2, 4, seed=11, threads=2)
    before = {
        "planner": pm.planner_decisions.value(path="root_grouped"),
        "sets": pm.planner_sets.value(path="root_grouped"),
        "hits": pm.epoch_table_hits.value(),
        "stages": {s: pm.stage_snapshot().get(s, {}).get("count", 0)
                   for s in ("marshal", "rand", "dispatch", "device_wait")},
    }
    assert facade.epoch_table_populate(0, [s.pubkey.to_bytes() for s in sets]) == 8
    assert pm.epoch_table_occupancy_gauge.value() == 8
    assert facade.verify_signature_sets(sets) is True
    assert pm.planner_decisions.value(path="root_grouped") == before["planner"] + 1
    assert pm.planner_sets.value(path="root_grouped") == before["sets"] + 8
    assert pm.epoch_table_hits.value() == before["hits"] + 8
    stages = pm.stage_snapshot()
    for s, n in before["stages"].items():
        assert stages[s]["count"] == n + 1, s
    events = compile_ledger.ledger().snapshot()["events"]
    assert any(e["kernel"] == "grouped_raw" and e["key"].startswith("torch.int32[2x4x32]")
               for e in events)
    snap = facade.epoch_table_snapshot()
    assert snap["enabled"] is True and "enabled" not in facade._inner._epoch_table.snapshot()


# --- per-stage device time -----------------------------------------------------------


def test_profile_stages_observes_the_jax_stage_names():
    pm = PipelineMetrics()
    with pytest.raises(ValueError):
        stage_profile.profile_stages(pm, batch=6, device="cpu")
    out = stage_profile.profile_stages(pm, batch=8, reps=1, device="cpu")
    assert set(out) == {"g2_decompress", "msm_planes", "miller_loop", "product_tree",
                        "final_exp", "plane_subgroup"}
    assert all(v > 0 for v in out.values())
    snap = pm.stage_snapshot()
    assert {k: v["count"] for k, v in snap.items()} == {k: 1 for k in out}
    assert snap["miller_loop"]["sum_s"] == out["miller_loop"]
