"""The port's `BlsLaneDispatcher` (`chain/dispatcher.py`) against the JAX
package's, both over the same gated or sleeping stub verifier, on the
scenarios of `tests/test_lane_dispatcher.py`: strict priority drain
order, eviction stopping at equal priority, the breaker halving the lane
caps, the overlap batch, a prompt typed shed (< 1 s), close semantics and
the H(m) dedup. Each scenario returns what a caller and a dashboard see
(outcomes, the verifier's calls, `_lanes_state()`, the lane counters of
`lanes_snapshot()`); the two must be equal. Then the port's defaults
against the JAX env registry."""

import threading
import time
from types import SimpleNamespace

import pytest

from lodestar_tpu.chain import bls_verifier as jax_bv
from lodestar_tpu.chain import dispatcher as jax_disp
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipeline
from lodestar_tpu_torch.chain import bls_verifier as port_bv
from lodestar_tpu_torch.chain import dispatcher as port_disp
from lodestar_tpu_torch.observability.stages import PipelineMetrics as PortPipeline

SIDES = {
    "jax": (jax_disp, jax_bv, JaxPipeline),
    "port": (port_disp, port_bv, PortPipeline),
}
WAITER_TIMEOUT_S = 60.0  # far above any prompt shed


class Side:
    def __init__(self, name):
        self.disp, self.bv, self.pipeline_cls = SIDES[name]
        self.Shed = self.bv.BlsShedError

    def gate(self):
        mock = self.bv.MockBlsVerifier

        class Gate(mock):
            """Blocks each verify until `gate` is set: holds workers in flight."""

            def __init__(self):
                super().__init__(result=True)
                self.gate = threading.Event()
                self.started = threading.Event()
                self._lock = threading.Lock()
                self.calls = []
                self.warmed = []

            def verify_signature_sets(self, sets):
                with self._lock:
                    self.calls.append([getattr(s, "message", s) for s in sets])
                self.started.set()
                self.gate.wait(10.0)
                return super().verify_signature_sets(sets)

        return Gate()

    def dispatcher(self, verifier=None, **kw):
        kw.setdefault("max_sigs", 32)
        kw.setdefault("max_wait_ms", 10_000)  # the timer never fires in a test
        kw.setdefault("workers", 1)
        kw.setdefault("pending_cap", 0)
        kw.setdefault("lane_caps", {})
        kw.setdefault("waiter_timeout_s", WAITER_TIMEOUT_S)
        kw.setdefault("pipeline", self.pipeline_cls())
        return self.disp.BlsLaneDispatcher(verifier or self.bv.MockBlsVerifier(), **kw)

    def submit(self, d, sets, lane):
        out = []

        def run():
            t0 = time.monotonic()
            try:
                out.append(("ok", d.verify_signature_sets(sets, lane=lane)))
            except self.Shed as e:
                out.append(("shed", str(e), e.lane, e.n_sets, time.monotonic() - t0 < 1.0))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t, out

    def shed_now(self, d, sets, lane):
        t0 = time.monotonic()
        try:
            return ("ok", d.verify_signature_sets(sets, lane=lane))
        except self.Shed as e:
            return ("shed", str(e), e.lane, e.n_sets, time.monotonic() - t0 < 1.0)


def wait_queued(d, n_sets, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if d._lanes_state()["pending_sets"] >= n_sets:
            return
        time.sleep(0.005)
    raise AssertionError(f"never saw {n_sets} queued sets")


def counters(d):
    snap = d.pipeline.lanes_snapshot()
    return {k: snap[k] for k in ("sheds", "batches", "overlapped_batches", "overlap_fraction")}


def prompt_shed(s: Side):
    d = s.dispatcher(lane_caps={"attestation": 2})
    try:
        t1, o1 = s.submit(d, ["a1", "a2"], "attestation")
        wait_queued(d, 2)
        shed = s.shed_now(d, ["a3"], "attestation")
        state = d._lanes_state()
    finally:
        d.close()
        t1.join(5.0)
    return {"shed": shed, "queued": o1, "state": state, "counters": counters(d)}


def block_evicts_attestations(s: Side):
    d = s.dispatcher(pending_cap=2)
    try:
        t1, o1 = s.submit(d, ["a1", "a2"], "attestation")
        wait_queued(d, 2)
        block = d.verify_signature_sets(["b1", "b2"], lane="block")
        t1.join(5.0)
        out = {"block": block, "attestation": o1, "counters": counters(d)}
    finally:
        d.close()
    return out


def eviction_stops_at_equal_priority(s: Side):
    d = s.dispatcher(pending_cap=4)
    try:
        ta, oa = s.submit(d, ["att1", "att2"], "attestation")
        wait_queued(d, 2)
        tg, og = s.submit(d, ["agg1", "agg2"], "aggregate")
        wait_queued(d, 4)
        ts, os_ = s.submit(d, ["sc1", "sc2"], "sync_committee")
        ta.join(5.0)
        wait_queued(d, 4)
        state = d._lanes_state()
    finally:
        d.close()
        tg.join(5.0)
        ts.join(5.0)
    return {"att": oa, "agg": og, "sc": os_, "state": state, "counters": counters(d)}


def priority_drain_order(s: Side):
    inner = s.gate()
    d = s.dispatcher(inner, max_wait_ms=10, max_sigs=64)
    try:
        tp, op = s.submit(d, ["primer"], "aggregate")
        assert inner.started.wait(5.0)
        ta, oa = s.submit(d, ["att"], "attestation")
        wait_queued(d, 1)
        tb, ob = s.submit(d, ["blk"], "block")
        wait_queued(d, 2)
        inner.gate.set()
        for t in (tp, ta, tb):
            t.join(10.0)
    finally:
        d.close()
    return {"outcomes": [op, oa, ob], "calls": inner.calls, "counters": counters(d)}


def overlap(s: Side):
    inner = s.gate()
    d = s.dispatcher(inner, workers=2, max_wait_ms=10, max_sigs=4)
    try:
        tp, op = s.submit(d, ["primer"], "aggregate")
        assert inner.started.wait(5.0)
        ta, oa = s.submit(d, ["x1", "x2"], "attestation")
        deadline = time.monotonic() + 5.0
        while len(inner.calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        inner.gate.set()
        for t in (tp, ta):
            t.join(10.0)
    finally:
        d.close()
    return {"outcomes": [op, oa], "calls": inner.calls, "counters": counters(d)}


def breaker_halving(s: Side):
    inner = s.bv.MockBlsVerifier()
    inner.breaker_state = "open"
    d = s.dispatcher(inner, lane_caps={"attestation": 4})
    try:
        t1, o1 = s.submit(d, ["a1", "a2"], "attestation")
        wait_queued(d, 2)
        halved = s.shed_now(d, ["a3"], "attestation")
        inner.breaker_state = "closed"
        t2, o2 = s.submit(d, ["a3"], "attestation")
        wait_queued(d, 3)
        state = d._lanes_state()
    finally:
        d.close()
        t1.join(5.0)
        t2.join(5.0)
    return {"halved": halved, "first": o1, "second": o2, "state": state,
            "counters": counters(d)}


def close_semantics(s: Side):
    inner = s.bv.MockBlsVerifier()
    d = s.dispatcher(inner)
    t1, o1 = s.submit(d, ["a1"], "attestation")
    wait_queued(d, 1)
    d.close()
    t1.join(5.0)
    d.close()  # idempotent
    direct = d.verify_signature_sets(["s1"], lane="attestation")
    unknown = s.shed_now(d, ["s2"], "bogus_topic")  # closed: straight through
    return {"queued": o1, "direct": direct, "unknown": unknown, "seen": inner.sets_seen,
            "state": d._lanes_state(), "counters": counters(d)}


def unknown_lane_and_bypass(s: Side):
    inner = s.bv.MockBlsVerifier()
    d = s.dispatcher(inner, lane_caps={s.disp.DEFAULT_LANE: 1})
    try:
        shed = s.shed_now(d, ["s1", "s2"], "bogus_topic")
        bypass = d.verify_signature_sets(["s1"], batchable=False)
    finally:
        d.close()
    return {"shed": shed, "bypass": bypass, "seen": inner.sets_seen, "counters": counters(d)}


def h2c_dedup(s: Side):
    """Four entries over two roots coalesce into one batch; the verifier's
    `warm_h2c` gets each root once before the verdict and the dedup count
    is the duplicates."""
    inner = s.gate()
    inner.warm_h2c = lambda msgs: inner.warmed.append(sorted(msgs)) or len(msgs)
    d = s.dispatcher(inner, max_sigs=4)  # dispatches once all four are queued
    roots = [bytes([0x10 + i % 2]) * 32 for i in range(4)]
    try:
        inner.gate.set()
        threads = [s.submit(d, [SimpleNamespace(message=r)], "aggregate") for r in roots]
        for t, _ in threads:
            t.join(10.0)
    finally:
        d.close()
    dedup = d.pipeline.registry.expose()
    lines = [ln for ln in dedup.splitlines() if ln.startswith("lodestar_bls_h2c_dedup_total")]
    return {"outcomes": [o for _, o in threads], "warmed": inner.warmed,
            "calls": [sorted(c) for c in inner.calls], "dedup": lines}


SCENARIOS = {f.__name__: f for f in (
    prompt_shed, block_evicts_attestations, eviction_stops_at_equal_priority,
    priority_drain_order, overlap, breaker_halving, close_semantics, unknown_lane_and_bypass,
    h2c_dedup)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_outcomes_state_and_counters(name):
    jax = SCENARIOS[name](Side("jax"))
    port = SCENARIOS[name](Side("port"))
    assert port == jax
    if name == "prompt_shed":
        assert port["shed"][0] == "shed" and port["shed"][4] is True  # under 1 s
        assert port["queued"][0][0] == "shed" and "closed" in port["queued"][0][1]
    if name == "priority_drain_order":
        assert port["calls"] == [["primer"], ["blk", "att"]]
    if name == "eviction_stops_at_equal_priority":
        assert port["state"]["lanes"]["aggregate"]["queued_sets"] == 2
        assert port["att"][0][0] == "shed" and "evicted" in port["att"][0][1]
    if name == "overlap":
        assert port["counters"]["overlapped_batches"] == 1
    if name == "h2c_dedup":
        assert port["warmed"] == [sorted({bytes([0x10]) * 32, bytes([0x11]) * 32})]
        assert port["dedup"] == ["lodestar_bls_h2c_dedup_total 2.0"]


def test_defaults_are_the_jax_registrys():
    from lodestar_tpu.utils.env import REGISTRY

    d = port_disp.BlsLaneDispatcher(port_bv.MockBlsVerifier(), pipeline=PortPipeline())
    try:
        assert d.workers == REGISTRY["LODESTAR_TPU_LANE_WORKERS"].default
        assert d.max_coalesce == REGISTRY["LODESTAR_TPU_LANE_MAX_COALESCE"].default
        assert d.pending_cap == REGISTRY["LODESTAR_TPU_LANE_PENDING_CAP"].default
        assert d.lane_caps == {
            lane: REGISTRY[f"LODESTAR_TPU_LANE_CAP_{lane.upper()}"].default
            for lane in ("attestation", "aggregate", "sync_committee")}
        assert d._h2c_dedup is REGISTRY["LODESTAR_TPU_H2C_DEDUP"].default
        assert d.waiter_timeout == REGISTRY["LODESTAR_TPU_WAITER_TIMEOUT"].default
        assert d.max_sigs == jax_bv.MAX_BUFFERED_SIGS == port_bv.MAX_BUFFERED_SIGS
        assert d.max_wait * 1000 == jax_bv.MAX_BUFFER_WAIT_MS == port_bv.MAX_BUFFER_WAIT_MS
        assert port_bv.MAX_SIGNATURE_SETS_PER_JOB == jax_bv.MAX_SIGNATURE_SETS_PER_JOB
        assert port_disp.LANES == jax_disp.LANES
        assert port_disp.DEFAULT_LANE == jax_disp.DEFAULT_LANE
    finally:
        d.close()
    assert all(not t.is_alive() for t in d._threads)
