"""The port's mesh census (`lodestar_tpu_torch/parallel/mesh.py`) against
the JAX package's `parallel/mesh.py`, with stub verifier factories: no
worker process starts and no kernel runs.

- The JAX `tests/test_mesh_serving.py` stub-factory script (sizing,
  dispatch routing and counting, refusals, eviction and re-admission,
  the verifier cache, the one-shot chip fault, snapshots) and its
  supervisor wiring, and `tests/test_fleet.py`'s host-row census cases,
  run against both `BlsMeshDispatcher` classes (parametrised); a second
  test per scenario holds the port's return values and snapshots equal to
  the JAX class's. The JAX `testing.faults` module is the duck-typed
  `faults` object of the port's class; each class gets its own package's
  `FleetRouter` (the JAX router only for the JAX class, as the comparison).
- `mesh_divisor` over 1…80 equals the JAX one.
- The port's `auto_mesh` (the JAX `auto` default, no variable read) never
  meshes the CPU and meshes two CUDA devices, grouped into hosts by an
  active `FleetTopology`; the default factory builds the two-level twin
  for a two-level layout and `start_pool` starts a two-level pool.
"""

import pytest

from lodestar_tpu.chain.supervisor import SupervisedBlsVerifier
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipelineMetrics
from lodestar_tpu.parallel import mesh as jax_mesh
from lodestar_tpu.parallel.fleet import FleetRouter as JaxFleetRouter
from lodestar_tpu.testing import faults
from lodestar_tpu.testing.faults import InjectedChipFault, InjectedHostFault
from lodestar_tpu_torch.observability.stages import PipelineMetrics as TorchPipelineMetrics
from lodestar_tpu_torch.parallel import mesh as torch_mesh
from lodestar_tpu_torch.parallel.fleet import FleetRouter, FleetTopology


class Impl:
    """One side of the comparison: the dispatcher class, its observer
    class, its router class and its NOT_SHARDED."""

    def __init__(self, name, module, observer_cls, router_cls):
        self.name = name
        self.mesh = module
        self.observer_cls = observer_cls
        self.router_cls = router_cls
        self.NOT_SHARDED = module.NOT_SHARDED

    def dispatcher(self, devices, observer=None, calls=None, **kw):
        calls = calls if calls is not None else []
        if self.name == "torch":
            kw["faults"] = faults
        return self.mesh.BlsMeshDispatcher(
            devices, observer=observer or self.observer_cls(),
            verifier_factory=_factory_recorder(calls), **kw)


IMPLS = {
    "jax": Impl("jax", jax_mesh, JaxPipelineMetrics, JaxFleetRouter),
    "torch": Impl("torch", torch_mesh, TorchPipelineMetrics, FleetRouter),
}


class _Arr:
    def __init__(self, shape):
        self.shape = shape


class _FakeGrouped:
    """Shape-only stand-in for GroupedArrays (rows, lanes)."""

    def __init__(self, rows, lanes):
        self.pk_x = _Arr((rows, lanes))
        self.msg_x = _Arr((rows, lanes))


class _FakeArrs:
    """Shape-only stand-in for SetArrays (lanes)."""

    def __init__(self, lanes):
        self.pk_x = _Arr((lanes,))


class _StubVerifier:
    def __init__(self, kind, devices, axis):
        self.kind = kind
        self.devices = devices
        self.axis = axis
        self.submits = 0

    def submit(self, *args):
        self.submits += 1
        return True


def _factory_recorder(calls):
    def factory(kind, devices, axis):
        v = _StubVerifier(kind, devices, axis)
        calls.append(v)
        return v

    return factory


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear(reset_counters=True)
    yield
    faults.clear(reset_counters=True)


def _flat(impl, n_devices, observer=None, calls=None):
    return impl.dispatcher([f"dev{i}" for i in range(n_devices)], observer=observer, calls=calls)


def _fleet(impl, host_widths=(4, 4), observer=None, calls=None, router=None):
    devices, hosts, i = [], [], 0
    for w in host_widths:
        hosts.append(list(range(i, i + w)))
        devices.extend(f"dev{j}" for j in range(i, i + w))
        i += w
    return impl.dispatcher(devices, observer=observer, calls=calls, hosts=hosts, router=router)


# --- the JAX test_mesh_serving.py stub-factory script -------------------------
#
# Each scenario runs the JAX test's assertions and returns what it saw
# (return values, snapshots), which the second test compares across the
# two classes.


def scenario_serving_prefix_and_sizing(impl):
    d = _flat(impl, 5)
    assert d.size == 4 and d.enabled
    assert d._serving_chips() == [0, 1, 2, 3]  # chip 4 healthy but idle
    assert _flat(impl, 1).enabled is False
    return [d.size, d._serving_chips(), d.snapshot()]


def scenario_dispatch_grouped_routes_and_counts(impl):
    calls = []
    obs = impl.observer_cls()
    d = _flat(impl, 4, observer=obs, calls=calls)
    g = _FakeGrouped(8, 64)
    seen = [d.dispatch_grouped(g, None, None)]
    assert seen[0] is True
    assert len(calls) == 1 and calls[0].kind == "grouped"
    assert calls[0].devices == ["dev0", "dev1", "dev2", "dev3"]
    # same shape: the verifier is cached, not rebuilt
    seen.append(d.dispatch_grouped(g, None, None))
    assert seen[1] is True
    assert len(calls) == 1 and calls[0].submits == 2
    snap = obs.mesh_snapshot()
    assert snap["size"] == 4 and snap["evicted"] == 0
    assert snap["chip_dispatches"] == {"0": 2, "1": 2, "2": 2, "3": 2}
    return seen + [snap, d.snapshot(), [(v.kind, v.devices, v.axis) for v in calls]]


def scenario_dispatch_raw_routes_and_counts(impl):
    calls = []
    obs = impl.observer_cls()
    d = _flat(impl, 4, observer=obs, calls=calls)
    g = _FakeGrouped(8, 64)
    seen = [d.dispatch_grouped_raw(g, None, None, None)]
    assert seen[-1] is True
    assert len(calls) == 1 and calls[0].kind == "grouped_raw"
    assert calls[0].devices == ["dev0", "dev1", "dev2", "dev3"]
    seen.append(d.dispatch_pk_grouped_raw(g, None, None, None))
    assert seen[-1] is True
    assert len(calls) == 2 and calls[1].kind == "pk_grouped_raw"
    seen.append(d.dispatch_grouped_raw(g, None, None, None))
    seen.append(d.dispatch_pk_grouped_raw(g, None, None, None))
    assert len(calls) == 2
    assert calls[0].submits == 2 and calls[1].submits == 2
    snap = obs.mesh_snapshot()
    assert snap["chip_dispatches"] == {"0": 4, "1": 4, "2": 4, "3": 4}
    return seen + [snap, d.snapshot()]


def scenario_dispatch_raw_refuses_indivisible_and_tiny(impl):
    d = _flat(impl, 4)
    seen = [
        d.dispatch_grouped_raw(_FakeGrouped(9, 64), None, None, None),
        d.dispatch_pk_grouped_raw(_FakeGrouped(6, 8), None, None, None),
        _flat(impl, 1).dispatch_grouped_raw(_FakeGrouped(8, 64), None, None, None),
    ]
    assert all(s is impl.NOT_SHARDED for s in seen)
    return ["NOT_SHARDED" for _ in seen] + [d.snapshot()]


def scenario_dispatch_refuses_indivisible_and_tiny_batches(impl):
    d = _flat(impl, 4)
    ns = impl.NOT_SHARDED
    assert d.dispatch_grouped(_FakeGrouped(9, 64), None, None) is ns
    assert d.dispatch_pk_grouped(_FakeGrouped(6, 8), None, None) is ns
    # bisect additionally needs the host-padded power-of-two batch
    assert d.dispatch_bisect(_FakeArrs(24), None) is ns
    assert d.dispatch_bisect(_FakeArrs(16), None) is True
    # a 1-device "mesh" never shards
    assert _flat(impl, 1).dispatch_grouped(_FakeGrouped(8, 64), None, None) is ns
    return [d.snapshot()]


def scenario_eviction_shrinks_readmission_restores(impl):
    obs = impl.observer_cls()
    d = _flat(impl, 4, observer=obs)
    seen = [d.evict(chip=2, reason="deadline")]
    assert seen[-1] == 2  # 3 healthy -> size 2
    assert d.has_evicted()
    assert d._serving_chips() == [0, 1]
    # no attribution: drop the highest-index healthy chip, keep chip 0
    seen.append(d.evict(reason="failure"))
    assert seen[-1] == 2
    assert d._serving_chips() == [0, 1]
    seen.append(d.evict())
    assert seen[-1] == 1  # 1 healthy: still evictable down to the last
    seen.append(d.evict())
    assert seen[-1] is None  # nothing left to evict: caller stops
    snap = d.snapshot()
    assert snap["healthy"] == [0] and len(snap["evicted"]) == 3
    seen.append(d.readmit())
    assert seen[-1] == 3
    assert not d.has_evicted() and d.size == 4
    m = obs.mesh_snapshot()
    assert m["evictions"] == {"deadline": 1, "failure": 2}
    assert m["readmissions"] == 3 and m["evicted"] == 0 and m["size"] == 4
    return seen + [snap, m, d.snapshot()]


def scenario_verifier_cache_keyed_by_chip_set(impl):
    calls = []
    d = _flat(impl, 4, calls=calls)
    g = _FakeGrouped(8, 64)
    d.dispatch_grouped(g, None, None)
    d.evict(chip=3)
    d.dispatch_grouped(g, None, None)  # 2-chip mesh: a new verifier
    assert [v.devices for v in calls] == [
        ["dev0", "dev1", "dev2", "dev3"], ["dev0", "dev1"],
    ]
    # re-admission returns to the original chip set: its verifier is
    # still cached, no third factory call
    d.readmit()
    d.dispatch_grouped(g, None, None)
    assert len(calls) == 2 and calls[0].submits == 2
    return [[v.devices for v in calls], d.snapshot()]


def scenario_chip_fault_is_one_shot_and_attributed(impl):
    d = _flat(impl, 4)
    faults.configure("chip:1")
    g = _FakeGrouped(8, 64)
    with pytest.raises(InjectedChipFault) as ei:
        d.dispatch_grouped(g, None, None)
    assert ei.value.chip == 1
    # ONE-SHOT: the plan disarmed itself; the retry after eviction works
    seen = [d.evict(chip=ei.value.chip, reason="InjectedChipFault")]
    assert seen[-1] == 2
    seen.append(d.dispatch_grouped(g, None, None))
    assert seen[-1] is True
    assert faults.snapshot()["injected"]["chip"] == 1
    return seen + [d.snapshot()]


def scenario_snapshot_shape(impl):
    d = _flat(impl, 3)
    d.dispatch_grouped(_FakeGrouped(8, 64), None, None)
    snap = d.snapshot()
    assert snap["devices_total"] == 3 and snap["size"] == 2
    assert snap["serving"] == [0, 1] and snap["dispatches"] == 1
    assert snap["compiled"] == ["grouped:8x64@2"]
    return [snap]


# --- the JAX test_mesh_serving.py supervisor wiring ---------------------------


class _FakeMeshDevice:
    """Device facade whose first N dispatches raise an attributed chip
    fault; mesh_* mirrors the dispatcher surface the supervisor uses."""

    def __init__(self, impl, fail_chips=(2,)):
        self._pending = list(fail_chips)
        self.dispatcher = _flat(impl, 4)
        self.calls = 0

    def verify_signature_sets(self, sets):
        self.calls += 1
        if self._pending:
            raise InjectedChipFault(self._pending.pop(0))
        return True

    def mesh_evict(self, chip=None, reason="failure"):
        return self.dispatcher.evict(chip=chip, reason=reason)

    def mesh_readmit(self):
        return self.dispatcher.readmit()

    def mesh_has_evicted(self):
        return self.dispatcher.has_evicted()

    def mesh_snapshot(self):
        return self.dispatcher.snapshot()


class _FakeCpu:
    def __init__(self):
        self.calls = 0

    def verify_signature_sets(self, sets):
        self.calls += 1
        return True

    def verify_signature_sets_individual(self, sets):
        self.calls += 1
        return [True] * len(sets)


def _supervised(device):
    return SupervisedBlsVerifier(device, _FakeCpu(), observer=JaxPipelineMetrics(),
                                 deadline_s=0, canary_thread=False)


def scenario_supervisor_evicts_sick_chip_and_keeps_serving(impl):
    device = _FakeMeshDevice(impl, fail_chips=(2,))
    sup = _supervised(device)
    assert sup.verify_signature_sets([object()]) is True
    # the chip fault cost an eviction + an immediate retry, not a CPU
    # fallback, a transient retry, or a breaker failure
    assert device.calls == 2
    assert sup.cpu.calls == 0
    assert sup.breaker_state == "closed"
    snap = device.mesh_snapshot()
    assert [e["chip"] for e in snap["evicted"]] == [2]
    assert snap["evicted"][0]["reason"] == "InjectedChipFault"
    assert sup.breaker_snapshot()["mesh"]["size"] == 2
    return [snap]


def scenario_supervisor_falls_back_once_mesh_exhausted(impl):
    device = _FakeMeshDevice(impl, fail_chips=(0, 0, 0, 0, 0))
    sup = _supervised(device)
    assert sup.verify_signature_sets([object()]) is True
    assert sup.cpu.calls == 1
    assert device.mesh_snapshot()["healthy"] == [1]
    return [device.mesh_snapshot()]


def scenario_supervisor_probe_readmits_evicted_chips(impl):
    device = _FakeMeshDevice(impl, fail_chips=(1,))
    sup = _supervised(device)
    assert sup.verify_signature_sets([object()]) is True
    assert device.mesh_has_evicted()
    sup._canary_sets = [object()]
    assert sup.probe() is True
    assert not device.mesh_has_evicted()
    assert device.dispatcher.size == 4
    return [device.mesh_snapshot()]


# --- the JAX test_fleet.py host-row census cases ----------------------------


def scenario_fleet_dispatch_routes_two_level_and_counts(impl):
    calls = []
    obs = impl.observer_cls()
    d = _fleet(impl, (4, 4), observer=obs, calls=calls)
    assert d.size == 8 and d.hosts_serving == 2 and d.hosts_total == 2
    g = _FakeGrouped(8, 64)
    assert d.dispatch_grouped(g, None, None) is True
    assert len(calls) == 1
    # the factory saw per-host ROWS and the (dcn, ici) axis pair
    assert calls[0].devices == [["dev0", "dev1", "dev2", "dev3"],
                                ["dev4", "dev5", "dev6", "dev7"]]
    assert calls[0].axis == (d.dcn_axis, d.ici_axis)
    assert d.dispatch_grouped(g, None, None) is True
    assert len(calls) == 1 and calls[0].submits == 2  # cached
    snap = d.fleet_snapshot()
    assert snap["hosts_serving"] == 2
    assert snap["host_dispatches"] == {"0": 2, "1": 2}
    fleet = obs.fleet_snapshot()
    assert fleet["host_dispatches"] == {"0": 2, "1": 2}
    fleet.pop("dcn_collective_seconds")  # a wall time
    return [snap, fleet, d.snapshot()]


def scenario_fleet_layout_uniform_pow2_rows(impl):
    calls = []
    d = _fleet(impl, (4, 3), calls=calls)
    assert d.size == 4  # 2 hosts x 2 chips
    assert d.dispatch_grouped(_FakeGrouped(8, 64), None, None) is True
    assert calls[0].devices == [["dev0", "dev1"], ["dev4", "dev5"]]
    return [d.snapshot()]


def scenario_fleet_verifier_cache_keyed_by_host_set(impl):
    calls = []
    d = _fleet(impl, (2, 2), calls=calls)
    g = _FakeGrouped(8, 64)
    assert d.dispatch_grouped(g, None, None) is True
    assert d.evict_host(1, reason="drill") is not None
    assert d.dispatch_grouped(g, None, None) is True
    d.readmit()
    assert d.dispatch_grouped(g, None, None) is True
    assert len(calls) == 2
    assert calls[0].devices == [["dev0", "dev1"], ["dev2", "dev3"]]
    assert calls[1].devices == ["dev0", "dev1"]  # single-host: flat
    assert calls[1].axis == "dp"
    assert calls[0].submits == 2 and calls[1].submits == 1
    return [d.snapshot(), d.fleet_snapshot()]


def scenario_host_eviction_rebalances_and_readmit_restores(impl):
    obs = impl.observer_cls()
    router = impl.router_cls(2, 0, observer=obs)
    d = _fleet(impl, (4, 4), observer=obs, router=router)
    moved_expected = len(router.slice_for(1))
    assert d.evict_host(1, reason="drill") == 4
    assert d.hosts_serving == 1 and d.has_evicted()
    assert router.snapshot()["active_hosts"] == [0]
    snap = d.fleet_snapshot()
    assert snap["evicted_hosts"] == [{"host": 1, "reason": "drill"}]
    assert snap["router"]["subnets_moved"] == moved_expected
    counters = obs.fleet_snapshot()
    assert counters["host_evictions"] == {"drill": 1}
    assert counters["subnets_moved"] == moved_expected
    assert d.readmit() == 1
    assert d.hosts_serving == 2 and not d.has_evicted()
    assert router.snapshot()["evicted_hosts"] == []
    return [snap, counters, d.snapshot()]


def scenario_host_eviction_edge_cases(impl):
    d = _fleet(impl, (4, 4))
    seen = [d.evict_host(1), d.evict_host()]
    assert seen == [4, None]  # the last serving host stays
    single = _flat(impl, 4)
    assert single.evict_host() is None  # single-host census: no-op
    assert single.fleet_snapshot() is None
    return seen + [d.snapshot()]


def scenario_unattributed_host_eviction_keeps_root_host(impl):
    # host 0 owns the two-level root tail: default eviction drops the
    # highest-rank active host, never host 0
    d = _fleet(impl, (2, 2, 2, 2))
    assert d.hosts_serving == 4
    d.evict_host()
    d.evict_host()
    snap = d.fleet_snapshot()
    assert [e["host"] for e in snap["evicted_hosts"]] == [3, 2]
    assert d.hosts_serving == 2
    return [snap]


def scenario_host_fault_is_one_shot_and_attributed(impl):
    faults.configure("host:1")
    d = _fleet(impl, (2, 2))
    g = _FakeGrouped(8, 64)
    with pytest.raises(InjectedHostFault) as exc:
        d.dispatch_grouped(g, None, None)
    assert exc.value.host == 1
    assert d.dispatch_grouped(g, None, None) is True
    assert faults.snapshot()["injected"]["host"] == 1
    return [d.snapshot(), d.fleet_snapshot()]


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_census_script(scenario, impl):
    SCENARIOS[scenario](IMPLS[impl])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_census_equals_the_jax_dispatchers(scenario):
    theirs = SCENARIOS[scenario](IMPLS["jax"])
    faults.clear(reset_counters=True)
    ours = SCENARIOS[scenario](IMPLS["torch"])
    assert ours == theirs


def test_mesh_divisor_equals_the_jax_one():
    assert [torch_mesh.mesh_divisor(n) for n in range(1, 81)] == [
        jax_mesh.mesh_divisor(n) for n in range(1, 81)]
    assert torch_mesh.CONSTANT_LANES == jax_mesh.CONSTANT_LANES


def test_auto_mesh_meshes_only_several_cuda_devices(monkeypatch):
    import torch

    assert torch_mesh.auto_mesh(TorchPipelineMetrics(), "cpu") is None
    assert torch_mesh.auto_mesh(TorchPipelineMetrics(), None) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_mesh.auto_mesh(TorchPipelineMetrics(), "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert torch_mesh.auto_mesh(TorchPipelineMetrics(), "cpu") is None
    d = torch_mesh.auto_mesh(TorchPipelineMetrics(), "cuda")
    assert d.enabled and d.size == 2 and d.pool is None  # the pool starts lazily
    assert d.snapshot()["devices_total"] == 2


def test_auto_mesh_groups_cuda_devices_into_fleet_hosts(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    d = torch_mesh.auto_mesh(TorchPipelineMetrics(), "cuda", fleet=FleetTopology.parse("emulate"))
    assert d.hosts_serving == 2 and d.size == 4 and d.pool is None
    assert d.fleet_snapshot()["layout"] == {"0": [0, 1], "1": [2, 3]}
    off = torch_mesh.auto_mesh(TorchPipelineMetrics(), "cuda", fleet=FleetTopology.parse("off"))
    assert off.hosts_total == 1 and off.size == 4
    assert torch_mesh.auto_mesh(TorchPipelineMetrics(), "cpu",
                                fleet=FleetTopology.parse("emulate")) is None


def test_default_factory_builds_the_two_level_twin_and_pool():
    from lodestar_tpu_torch.parallel import sharded

    d = torch_mesh.BlsMeshDispatcher(["cpu"] * 2, observer=TorchPipelineMetrics(),
                                     hosts=[[0], [1]])
    try:
        assert d.hosts_serving == 2 and d.size == 2
        v, chips, rows = d._verifier("grouped", (8, 64))
        assert isinstance(v, sharded.ShardedGroupedVerifier) and v.ndev == 2
        assert v.devices == [["cpu"], ["cpu"]] and chips == (0, 1)
        pool = d.start_pool()
        assert pool is d.pool and pool.layout == (("cpu",), ("cpu",))
        assert pool.hosts == 2 and pool.per == 1
        assert pool.places() == [(0, 0, 0), (1, 1, 0)]
        assert v.pool is pool  # the twin runs on the dispatcher's pool
    finally:
        d.close()
    assert d.pool is None and not any(pool.alive())
