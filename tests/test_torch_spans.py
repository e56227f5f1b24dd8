"""The port's lifecycle tracing (`observability/spans.py`) against the JAX
package's: the scripts of `tests/test_spans.py` (nesting and parentage,
asyncio tasks, the cross-thread hand-off, ring eviction, disabled mode,
error status and filtering, attribute promotion, `on_finish`) run on both
tracers, their trace documents compared field by field apart from ids and
times; `record_slot_milestone` on a stub chain; the port's supervisor
against the JAX supervisor on one scripted device under a root trace (the
same span tree on each process-wide tracer); and on the CPU,
`build_bls_stack` serving `/debug/traces` and counting finished traces
into `lodestar_lifecycle_traces_total`."""

import asyncio
import json
import threading
import urllib.request

import pytest

from lodestar_tpu.chain import supervisor as jax_sup
from lodestar_tpu.chain.bls_verifier import MockBlsVerifier as JaxMock
from lodestar_tpu.observability import spans as jax_spans
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipeline
from lodestar_tpu.testing import faults as jax_faults
from lodestar_tpu_torch.chain import supervisor as port_sup
from lodestar_tpu_torch.chain.bls_verifier import MockBlsVerifier as PortMock
from lodestar_tpu_torch.observability import spans as port_spans
from lodestar_tpu_torch.observability.stages import PipelineMetrics as PortPipeline

MODULES = {"jax": jax_spans, "port": port_spans}


def normalize(doc: dict) -> dict:
    """A trace document without its ids and times: every span's parent is
    named instead of identified, events keep their names and attributes."""
    names = {s["span_id"]: s["name"] for s in doc["spans"]}
    spans = []
    for s in doc["spans"]:
        rec = {k: v for k, v in s.items()
               if k not in ("span_id", "parent_id", "start_s", "duration_s")}
        rec["parent"] = names.get(s["parent_id"])
        if "events" in rec:
            rec["events"] = [{k: v for k, v in e.items() if k != "t_s"} for e in rec["events"]]
        spans.append(rec)
    out = {k: v for k, v in doc.items() if k not in ("trace_id", "ts", "duration_s", "spans")}
    out["spans"] = sorted(spans, key=lambda r: (r["name"], json.dumps(r, sort_keys=True)))
    return out


# -- the scripts of tests/test_spans.py, one tracer module each -----------------


def script_nesting(mod):
    t = mod.Tracer(capacity=8)
    with t.trace("root", kind="test"):
        with t.span("child"):
            with t.span("grandchild"):
                pass
        with t.span("sibling"):
            pass
    return t, {}


def script_asyncio(mod):
    t = mod.Tracer(capacity=8)

    async def main():
        with t.trace("root"):
            async def child(i):
                with t.span(f"task{i}"):
                    await asyncio.sleep(0.01)

            await asyncio.gather(child(0), child(1), child(2))

    asyncio.run(main())
    return t, {}


def script_cross_thread(mod):
    t = mod.Tracer(capacity=8)
    seen = {}
    with t.trace("root"):
        ctx = t.context()

        def work():
            seen["before"] = t.current_trace_id()
            with t.attach(ctx), t.span("worker"):
                seen["inside"] = t.current_trace_id()

        th = threading.Thread(target=work)
        th.start()
        th.join(10)
    (doc,) = t.traces()
    return t, {"before": seen["before"], "inside_is_trace": seen["inside"] == doc["trace_id"]}


def script_ring(mod):
    t = mod.Tracer(capacity=4)
    for i in range(10):
        with t.trace(f"t{i}"):
            pass
    return t, {"completed_total": t.completed_total,
               "names": [d["name"] for d in t.traces(limit=100)]}


def script_disabled(mod):
    t = mod.Tracer(enabled=False)
    same = t.span("a") is t.span("b") is t.trace("c")
    with t.trace("x"):
        with t.span("y"):
            pass
    with t.attach(None):
        pass
    t.span("z").annotate(slot=1).event("e")
    return t, {"same": same, "context": t.context(), "trace_id": t.current_trace_id()}


def script_error_and_filters(mod):
    t = mod.Tracer(capacity=8)
    with pytest.raises(RuntimeError):
        with t.trace("bad", slot=3):
            raise RuntimeError("boom")
    with t.trace("good"):
        t.annotate(slot=4, root="ab" * 16)
    return t, {"slot3": [d["name"] for d in t.traces(slot=3)],
               "root": [d["name"] for d in t.traces(root="0x" + "ab" * 16)],
               "slot99": t.traces(slot=99)}


def script_promotion(mod):
    t = mod.Tracer(capacity=8)
    with t.trace("gossip/beacon_block", kind="beacon_block"):
        with t.span("validation/block", slot=11):
            t.event("block_received", slot=11)
    return t, {"by_slot": [d["name"] for d in t.traces(slot=11)]}


def script_on_finish(mod):
    t = mod.Tracer(capacity=8)
    kinds = []
    t.on_finish.append(lambda doc: kinds.append(doc["name"]))
    t.on_finish.append(lambda doc: 1 / 0)  # an observer that fails is ignored
    with t.trace("a"):
        pass
    return t, {"kinds": kinds}


SCRIPTS = {f.__name__[len("script_"):]: f for f in (
    script_nesting, script_asyncio, script_cross_thread, script_ring, script_disabled,
    script_error_and_filters, script_promotion, script_on_finish)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_trace_documents_as_the_jax_tracer(name):
    results = {}
    for side, mod in MODULES.items():
        t, seen = SCRIPTS[name](mod)
        results[side] = ([normalize(d) for d in t.traces(limit=100)], seen)
    assert results["port"] == results["jax"]
    docs, seen = results["port"]
    if name == "nesting":
        parents = {s["name"]: s["parent"] for s in docs[0]["spans"]}
        assert parents == {"root": None, "child": "root", "grandchild": "child",
                           "sibling": "root"}
    if name == "cross_thread":
        assert seen == {"before": None, "inside_is_trace": True}
    if name == "ring":
        assert seen["names"] == ["t9", "t8", "t7", "t6"] and seen["completed_total"] == 10
    if name == "disabled":
        assert docs == [] and seen == {"same": True, "context": None, "trace_id": None}
    if name == "error_and_filters":
        bad = next(d for d in docs if d["name"] == "bad")
        assert bad["spans"][0]["status"] == "error"
        assert "boom" in bad["spans"][0]["attrs"]["error"]
        assert seen == {"slot3": ["bad"], "root": ["good"], "slot99": []}
    if name == "promotion":
        assert docs[0]["slot"] == 11 and docs[0]["attrs"]["kind"] == "beacon_block"
    if name == "on_finish":
        assert seen == {"kinds": ["a"]}


def test_disabled_tracer_is_the_default_switch():
    assert port_spans.Tracer().enabled is True
    assert port_spans.Tracer().capacity == 256 == jax_spans.Tracer().capacity
    assert port_spans.MILESTONES == jax_spans.MILESTONES


class _Clock:
    def __init__(self, now):
        self.now = now

    def time_fn(self):
        return self.now

    def time_at_slot(self, slot):
        return 1000.0 + 12.0 * slot


class _Series:
    def __init__(self):
        self.calls = []

    def observe(self, value, **labels):
        self.calls.append(("observe", round(value, 6), labels))

    def set(self, value, **labels):
        self.calls.append(("set", round(value, 6), labels))


class _Metrics:
    def __init__(self):
        self.slot_milestone_seconds = _Series()
        self.slot_milestone_last = _Series()


class _Chain:
    def __init__(self, metrics=True):
        self.clock = _Clock(1000.0 + 12.0 * 7 + 1.23456)
        self.metrics = _Metrics() if metrics else None


def test_record_slot_milestone_on_a_stub_chain():
    out = {}
    for side, mod in MODULES.items():
        chain, bare = _Chain(), _Chain(metrics=False)
        with mod.tracer.trace("chain/process_block", slot=7) as root:
            delays = [mod.record_slot_milestone(chain, m, 7) for m in mod.MILESTONES]
            delays.append(mod.record_slot_milestone(bare, "imported", 7))
        events = [{k: v for k, v in e.items() if k != "t_s"} for e in root.events]
        out[side] = (delays, list(chain.metrics.slot_milestone_seconds.calls),
                     list(chain.metrics.slot_milestone_last.calls), events)
        # outside any trace: the metrics only, no error
        assert mod.record_slot_milestone(chain, "validated", 7) == pytest.approx(1.23456)
    assert out["port"] == out["jax"]
    delays, observed, last, events = out["port"]
    assert delays == [pytest.approx(1.23456)] * 6
    assert [c[2]["milestone"] for c in observed] == list(port_spans.MILESTONES)
    assert [e["name"] for e in events] == list(port_spans.MILESTONES) + ["imported"]
    assert events[0] == {"name": "block_received", "slot": 7, "delay_s": 1.2346}


# -- the supervisor's spans on each process-wide tracer -------------------------


class _Device:
    """'ok', 'false' or 'raise' per dispatch; the last one repeats."""

    observer = None

    def __init__(self, *script):
        self.script = list(script)

    def _step(self):
        b = self.script[0]
        if len(self.script) > 1:
            self.script.pop(0)
        if b == "raise":
            raise RuntimeError("synthetic device failure")
        return b == "ok"

    def verify_signature_sets(self, sets):
        return self._step()

    def verify_signature_sets_individual(self, sets):
        return [self._step()] * len(sets)


SIDES = {"jax": (jax_sup, JaxPipeline, JaxMock, jax_spans),
         "port": (port_sup, PortPipeline, PortMock, port_spans)}


def _supervised_trees(side):
    mod, pipeline, mock, sp = SIDES[side]
    dev = _Device("ok", "ok", "ok", "raise")
    sup = mod.SupervisedBlsVerifier(
        dev, mock(True), observer=pipeline(), deadline_s=5.0, failure_threshold=1, retries=0,
        retry_base_delay_s=0.0, canary_thread=False, canary_sets=[object()])
    sets = [object(), object()]
    docs = []
    try:
        # outside a trace: no span, no trace
        sup.verify_signature_sets(sets)
        steps = (("batch", sup.verify_signature_sets),
                 ("individual", sup.verify_signature_sets_individual),
                 ("batch", sup.verify_signature_sets),  # the device raises: breaker opens
                 ("probe", lambda s: sup.probe()))
        for i, (kind, call) in enumerate(steps):
            with sp.tracer.trace("chain/process_block", slot=i, root=f"{i:064x}") as root:
                ctx = sp.tracer.context()
                box = {}

                def verify():
                    with sp.tracer.attach(ctx), sp.tracer.span("chain/bls_verify", sets=2):
                        box["out"] = call(sets)

                th = threading.Thread(target=verify)
                th.start()
                th.join(30)
            docs.append((kind, box.get("out"), normalize(
                next(d for d in sp.tracer.traces(limit=256) if d["trace_id"] == root.trace_id))))
    finally:
        sup.close()
    return docs


def test_supervisor_span_tree_equals_the_jax_supervisors():
    jax_faults.clear(reset_counters=True)
    port = _supervised_trees("port")
    jax = _supervised_trees("jax")
    assert port == jax
    trees = {kind: {s["name"]: s["parent"] for s in doc["spans"]} for kind, _, doc in port}
    assert trees["individual"]["bls/supervised_individual"] == "chain/bls_verify"
    assert trees["probe"]["bls/canary_probe"] == "chain/bls_verify"
    raised = port[2][2]["spans"]
    by_name = {s["name"]: s for s in raised}
    assert by_name["bls/supervised_batch"]["parent"] == "chain/bls_verify"
    assert by_name["bls/cpu_fallback"]["parent"] == "chain/bls_verify"
    events = [e["name"] for s in raised for e in s.get("events", [])]
    assert "bls/breaker_transition" in events
    # the supervisor's default tracer is the process-wide one; an injected one wins
    sup = port_sup.SupervisedBlsVerifier(_Device("ok"), PortMock(True), canary_thread=False)
    other = port_spans.Tracer()
    sup2 = port_sup.SupervisedBlsVerifier(_Device("ok"), PortMock(True), canary_thread=False,
                                          tracer=other)
    try:
        assert sup.tracer is port_spans.tracer and sup2.tracer is other
    finally:
        sup.close()
        sup2.close()


# -- the serving stack on the CPU -------------------------------------------------


class _RaisingFaults:
    """The facade's fault seam: every device dispatch raises, so the
    supervisor serves from the host tier (no device verdict runs)."""

    def on_device_dispatch(self, n_sets):
        raise RuntimeError("injected device exception")

    def flaky_verdict(self, verdict):
        return verdict

    def flaky_verdicts(self, verdicts):
        return verdicts

    def snapshot(self):
        return {"active": True}


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
        body = r.read().decode()
    return body if route == "/metrics" else json.loads(body)


def test_stack_serves_debug_traces_and_counts_them():
    from lodestar_tpu_torch.node.bls_stack import build_bls_stack
    from lodestar_tpu_torch.profile_verdict import make_sets

    sets = make_sets(2, 1, seed=5)
    tracer = port_spans.tracer
    stack = build_bls_stack(device="cpu", faults=_RaisingFaults(), metrics_port=0,
                            supervisor_args={"retries": 0, "canary_thread": False})
    try:
        assert stack.tracer is tracer and stack.supervisor.tracer is tracer
        done0 = tracer.completed_total
        with tracer.trace("chain/process_block", slot=9, root="cd" * 32, kind="block"):
            with tracer.span("chain/bls_verify", sets=2):
                assert stack.supervisor.verify_signature_sets(sets) is True
        with tracer.trace("gossip/attestation"):
            pass
        doc = _get(stack.server.port, "/debug/traces?root=0x" + "cd" * 32)
        assert doc["count"] == 1 and doc["enabled"] is True
        tree = {s["name"]: s for s in doc["traces"][0]["spans"]}
        names = {s["span_id"]: s["name"] for s in tree.values()}
        assert names[tree["bls/supervised_batch"]["parent_id"]] == "chain/bls_verify"
        assert names[tree["bls/cpu_fallback"]["parent_id"]] == "chain/bls_verify"
        assert tracer.completed_total - done0 == 2
        text = _get(stack.server.port, "/metrics")
        assert 'lodestar_lifecycle_traces_total{kind="block"} 1.0' in text
        assert 'lodestar_lifecycle_traces_total{kind="gossip/attestation"} 1.0' in text
        # a second stack replaces the first's hook: one count per trace
        second = build_bls_stack(device="cpu", supervisor_args={"canary_thread": False})
        try:
            with tracer.trace("chain/process_block", kind="block"):
                pass
            assert stack.lifecycle_traces.value(kind="block") == 1
            assert second.lifecycle_traces.value(kind="block") == 1
        finally:
            second.close()
        assert [cb for cb in tracer.on_finish if getattr(cb, "_stack_wired", False)] == []
    finally:
        stack.close()
    with tracer.trace("chain/process_block", kind="block"):
        pass
    assert stack.lifecycle_traces.value(kind="block") == 1
