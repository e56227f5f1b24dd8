"""The port's `SupervisedBlsVerifier` (`chain/supervisor.py`) against the
JAX package's on the same scripts: a scripted fake device (ok, False,
raise, a sleep past the deadline), the same fake host tier and a fake
clock drive both; the verdict sequences, the breaker-state sequences and
the `supervisor_snapshot()` dicts of the two `PipelineMetrics` must be
equal. Scenarios follow `tests/test_supervisor.py`: the breaker FSM, the
canary re-closing and re-opening it, a deadline abandoned, the negative
audit, both tiers failed, and mesh chip and fleet host eviction (the
port's `MeshWorkerError(chip, msg, host=1)` → `mesh_evict_host(1)`).
Then what only the port has: `close()` joins the canary thread, and
spans go through an injected tracer."""

import time

import pytest

from lodestar_tpu.chain import supervisor as jax_sup
from lodestar_tpu.chain.bls_verifier import MockBlsVerifier as JaxMock
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipeline
from lodestar_tpu.testing import faults
from lodestar_tpu_torch.chain import supervisor as port_sup
from lodestar_tpu_torch.chain.bls_verifier import MockBlsVerifier as PortMock
from lodestar_tpu_torch.observability.stages import PipelineMetrics as PortPipeline
from lodestar_tpu_torch.parallel.mesh_pool import MeshWorkerError

SIDES = {
    "jax": (jax_sup, JaxPipeline, JaxMock),
    "port": (port_sup, PortPipeline, PortMock),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    # the JAX pipeline's snapshot reads the JAX fault plan: keep it clear
    faults.clear(reset_counters=True)
    yield
    faults.clear(reset_counters=True)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class ScriptedDevice:
    """One behaviour per dispatch: 'ok' | 'false' | 'raise' | 'chip' |
    'host' | ('hang', seconds); the last one repeats."""

    observer = None

    def __init__(self, *script):
        self.script = list(script) or ["ok"]
        self.calls = 0
        self.evicted = []

    def _step(self):
        self.calls += 1
        b = self.script[0]
        if len(self.script) > 1:
            self.script.pop(0)
        if isinstance(b, tuple):
            time.sleep(b[1])
            return "ok"
        if b == "raise":
            raise RuntimeError("synthetic device failure")
        if b == "chip":
            raise MeshWorkerError(1, "worker 1 died")
        if b == "host":
            raise MeshWorkerError(2, "host 1 down", host=1)
        return b

    def verify_signature_sets(self, sets):
        return self._step() == "ok"

    def verify_signature_sets_individual(self, sets):
        return [self._step() == "ok"] * len(sets)


class MeshDevice(ScriptedDevice):
    """A scripted device behind a mesh of `size` chips in two hosts."""

    def __init__(self, *script, size=4):
        super().__init__(*script)
        self.size = size
        self.evicted_hosts = []

    def mesh_evict(self, chip=None, reason="failure"):
        if self.size <= 1:
            return None
        self.size -= 1
        self.evicted.append((chip, reason))
        return self.size

    def mesh_evict_host(self, host=None, reason="failure"):
        if self.size <= 2:
            return None
        self.size -= 2
        self.evicted_hosts.append((host, reason))
        return self.size

    def mesh_has_evicted(self):
        return self.size < 4

    def mesh_readmit(self):
        n, self.size = 4 - self.size, 4
        return n

    def mesh_snapshot(self):
        return {"size": self.size}


class Cpu:
    """A host tier that counts its calls, answers `result` or raises."""

    def __init__(self, mock, result=True):
        self.inner = mock(result)
        self.calls = 0
        self.raises = False

    def verify_signature_sets(self, sets):
        self.calls += 1
        if self.raises:
            raise RuntimeError("host tier down")
        return self.inner.verify_signature_sets(sets)

    def verify_signature_sets_individual(self, sets):
        self.calls += 1
        if self.raises:
            raise RuntimeError("host tier down")
        return self.inner.verify_signature_sets_individual(sets)


def make(side, device, cpu_result=True, **kw):
    mod, pipeline, mock = SIDES[side]
    p = pipeline()
    clock = Clock()
    kw.setdefault("deadline_s", 5.0)
    kw.setdefault("failure_threshold", 2)
    kw.setdefault("retries", 1)
    kw.setdefault("retry_base_delay_s", 0.0)
    kw.setdefault("canary_thread", False)
    kw.setdefault("canary_sets", [object()])
    sup = mod.SupervisedBlsVerifier(device, Cpu(mock, cpu_result), observer=p, time_fn=clock,
                                    **kw)
    return sup, p, clock


SETS = [object(), object(), object()]


def run(side, script, steps, device_cls=ScriptedDevice, cpu_result=True, **kw):
    """Drive one supervisor through `steps`; returns what a reader of it
    can see after each step, and the final snapshots."""
    dev = device_cls(*script)
    sup, p, clock = make(side, dev, cpu_result, **kw)
    trace = []
    try:
        for step in steps:
            if step == "batch":
                out = sup.verify_signature_sets(SETS)
            elif step == "individual":
                out = sup.verify_signature_sets_individual(SETS)
            elif step == "probe":
                out = sup.probe()
            elif step == "tick":
                clock.t += 7.0
                out = None
            elif step == "cpu_down":
                sup.cpu.raises = True
                out = None
            else:
                dev.script = list(step) if isinstance(step, list) else [step]
                out = None
            snap = sup.breaker_snapshot()
            trace.append((step if isinstance(step, str) else repr(step), out, sup.breaker_state,
                          snap["consecutive_failures"], snap.get("open_for_s")))
        final = {"counters": p.supervisor_snapshot(), "device_calls": dev.calls,
                 "cpu_calls": sup.cpu.calls, "evicted": dev.evicted,
                 "evicted_hosts": getattr(dev, "evicted_hosts", None),
                 "snapshot": {k: v for k, v in sup.breaker_snapshot().items()
                              if k != "counters"}}
    finally:
        sup.close()
    return trace, final


SCENARIOS = {
    "healthy": (["ok"], ["batch", "individual", "batch"], {}),
    "transient_retry": (["raise", "ok"], ["batch"], {}),
    "breaker_fsm": (["raise"], ["batch", "batch", "batch", "individual", "tick", "batch"], {}),
    "canary_recloses_and_reopens": (
        ["raise"], ["batch", "batch", "tick", "probe", "ok", "probe", "batch", "raise", "batch",
                    "batch", "probe", "tick"], {}),
    "negative_audit_overturns": (["false"], ["batch", "individual", "batch"], {}),
    "negative_confirmed": (["false"], ["batch", "individual"], {"cpu_result": False}),
    "audit_off": (["false"], ["batch", "individual"], {"audit_negative": False}),
    "both_tiers_failed": (["raise"], ["cpu_down", "batch", "individual"], {}),
    "no_retries": (["raise", "ok"], ["batch", "batch"], {"retries": 0}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_verdicts_states_and_counters(name):
    script, steps, kw = SCENARIOS[name]
    jax = run("jax", script, steps, **kw)
    port = run("port", script, steps, **kw)
    assert port == jax


def test_deadline_abandons_the_worker_and_serves_the_host_tier():
    """A device call that sleeps past the deadline: both supervisors
    abandon it, count the deadline, feed the breaker and serve the host
    tier's verdict; neither retries it."""
    steps = ["batch", "batch"]
    jax = run("jax", [("hang", 0.3)], steps, deadline_s=0.05, failure_threshold=5)
    port = run("port", [("hang", 0.3)], steps, deadline_s=0.05, failure_threshold=5)
    assert port == jax
    trace, final = port
    assert [t[1] for t in trace] == [True, True]
    assert final["counters"]["deadline_exceeded"] == 2
    assert final["counters"]["fallbacks"] == {"deadline": 2}
    assert final["device_calls"] == 2  # never retried


@pytest.mark.parametrize("kind", ["chip", "host"])
def test_mesh_eviction_retries_on_the_survivors(kind):
    """A `MeshWorkerError` naming a chip (or a host) evicts it and the
    same call is served by the surviving mesh: no host-tier call, no
    retry spent, the breaker closed; the canary probe re-admits."""
    steps = [[kind, "ok"], "batch", "probe", [kind, "ok"], "individual"]
    jax = run("jax", ["ok"], steps, device_cls=MeshDevice, failure_threshold=1, retries=0)
    port = run("port", ["ok"], steps, device_cls=MeshDevice, failure_threshold=1, retries=0)
    assert port == jax
    trace, final = port
    assert [t[1] for t in trace if t[0] in ("batch", "individual")] == [True, [True] * 3]
    assert final["cpu_calls"] == 0
    assert final["counters"]["retries"] == 0
    assert all(t[2] == "closed" for t in trace)
    if kind == "chip":
        assert final["evicted"][0] == (1, "MeshWorkerError")
        assert final["evicted_hosts"] == []
    else:
        assert final["evicted_hosts"][0] == (1, "MeshWorkerError")


def test_defaults_are_the_jax_registrys():
    from lodestar_tpu.utils.env import REGISTRY

    sup = port_sup.SupervisedBlsVerifier(ScriptedDevice(), Cpu(PortMock),
                                         observer=PortPipeline(), canary_thread=False)
    try:
        assert sup.deadline_s == REGISTRY["LODESTAR_TPU_DEVICE_DEADLINE"].default
        assert sup._retry_policy.max_attempts - 1 == REGISTRY["LODESTAR_TPU_DEVICE_RETRIES"].default
        assert sup.failure_threshold == REGISTRY["LODESTAR_TPU_BREAKER_THRESHOLD"].default
        assert sup.cooldown_s == REGISTRY["LODESTAR_TPU_BREAKER_COOLDOWN"].default
        assert sup.audit_negative is REGISTRY["LODESTAR_TPU_AUDIT_NEGATIVE"].default
    finally:
        sup.close()


def test_close_joins_the_canary_thread():
    """The canary thread probes every cooldown while the breaker is open;
    close() wakes its sleep and joins it, so no probe runs after close()
    returns."""
    dev = ScriptedDevice("raise")
    sup, _, _ = make("port", dev, failure_threshold=1, retries=0, cooldown_s=60.0,
                     canary_thread=True)
    sup.verify_signature_sets(SETS)
    assert sup.breaker_state == "open"
    canary = sup._canary_thread
    assert canary is not None and canary.is_alive()
    t0 = time.monotonic()
    sup.close()
    assert time.monotonic() - t0 < 5.0
    assert not canary.is_alive()
    assert sup._dispatcher._worker is None


def test_background_canary_recloses_the_breaker():
    dev = ScriptedDevice("raise")
    sup, p, _ = make("port", dev, failure_threshold=1, retries=0, cooldown_s=0.02,
                     canary_thread=True)
    try:
        sup.verify_signature_sets(SETS)
        assert sup.breaker_state == "open"
        dev.script = ["ok"]
        deadline = time.monotonic() + 5.0
        while sup.breaker_state != "closed" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sup.breaker_state == "closed"
        assert p.supervisor_snapshot()["canary"].get("ok", 0) >= 1
    finally:
        sup.close()


class Tracer:
    def __init__(self, active):
        self.active = active
        self.spans = []
        self.events = []

    def context(self):
        return object() if self.active else None

    def span(self, name, **attrs):
        import contextlib

        self.spans.append(name)
        return contextlib.nullcontext()

    def event(self, name, **attrs):
        self.events.append((name, attrs.get("to")))


@pytest.mark.parametrize("active", [True, False])
def test_spans_go_through_the_injected_tracer(active):
    tracer = Tracer(active)
    dev = ScriptedDevice("ok", "raise")
    sup, _, _ = make("port", dev, failure_threshold=1, retries=0, tracer=tracer)
    try:
        sup.verify_signature_sets(SETS)
        sup.verify_signature_sets(SETS)
    finally:
        sup.close()
    assert tracer.spans == (["bls/supervised_batch", "bls/supervised_batch",
                             "bls/cpu_fallback"] if active else [])
    assert tracer.events == [("bls/breaker_transition", "open")]
