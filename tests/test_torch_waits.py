"""The waits and the audit of a verdict inside the port's serving stack,
as stage counters of the pipeline (`lodestar_bls_pipeline_stage_seconds`)
and lifecycle span events:

- the lanes (`chain/dispatcher.py`) observe each admitted call's wait in
  its lane (`lane_wait`), and put one `bls/lane_batch` event on each
  traced caller's span, with the batch's id, sets, dispatch-queue wait
  and audit seconds;
- the supervisor (`chain/supervisor.py`) observes each device call's wait
  for its one dispatch thread (`dispatch_wait`; 0 inline, nothing for a
  blown deadline) and the host tier's seconds of a negative audit
  (`audit`, inside the profiler scope `bls/audit`);
- lifecycle spans reach a `torch.profiler` that the program's own switch
  did not start.

Fake devices and host tiers stand in for the card: only the timing and
the counters are under test."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lodestar_tpu_torch.chain.bls_verifier import MockBlsVerifier
from lodestar_tpu_torch.chain.dispatcher import BlsLaneDispatcher
from lodestar_tpu_torch.chain.supervisor import DeviceDeadlineExceeded, SupervisedBlsVerifier
from lodestar_tpu_torch.observability import spans
from lodestar_tpu_torch.observability.stages import PipelineMetrics

torch.set_num_threads(1)


def stage(pm, name) -> dict:
    return pm.stage_snapshot().get(name, {"sum_s": 0.0, "count": 0})


class HeldDevice(MockBlsVerifier):
    """A device tier whose first call holds the dispatch thread until
    `release` is set; `started` is set when it begins."""

    observer = None

    def __init__(self, result=True):
        super().__init__(result=result)
        self.started = threading.Event()
        self.release = threading.Event()
        self.held_s = None

    def verify_signature_sets(self, sets):
        if not self.started.is_set():
            self.started.set()
            t0 = time.monotonic()
            self.release.wait(10.0)
            self.held_s = time.monotonic() - t0
        return super().verify_signature_sets(sets)


class SlowHost(MockBlsVerifier):
    """A host tier that takes `seconds` for each verdict."""

    def __init__(self, result: bool, seconds: float):
        super().__init__(result=result)
        self.seconds = seconds

    def verify_signature_sets(self, sets):
        time.sleep(self.seconds)
        return super().verify_signature_sets(sets)

    def verify_signature_sets_individual(self, sets):
        time.sleep(self.seconds)
        return super().verify_signature_sets_individual(sets)


class Raising(MockBlsVerifier):
    observer = None

    def verify_signature_sets(self, sets):
        raise RuntimeError("synthetic device failure")


def supervisor(device, cpu=None, pm=None, **kw):
    kw.setdefault("retries", 0)
    kw.setdefault("canary_thread", False)
    return SupervisedBlsVerifier(device, cpu or MockBlsVerifier(), observer=pm or PipelineMetrics(),
                                 **kw)


def lanes(verifier, pm, **kw):
    kw.setdefault("max_sigs", 32)
    kw.setdefault("max_wait_ms", 10_000)
    kw.setdefault("workers", 1)
    kw.setdefault("pending_cap", 0)
    kw.setdefault("lane_caps", {})
    return BlsLaneDispatcher(verifier, pipeline=pm, **kw)


def in_threads(fns, timeout=10.0) -> list:
    out = [None] * len(fns)
    threads = [threading.Thread(target=lambda i=i, f=f: out.__setitem__(i, f()), daemon=True)
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()
    return out


# -- the lanes ---------------------------------------------------------------------


def test_lane_wait_is_observed_once_per_admitted_call():
    pm = PipelineMetrics()
    d = lanes(MockBlsVerifier(), pm, max_sigs=3, max_wait_ms=150)
    try:
        # alone in its lane: it leaves on the 150 ms timer
        assert d.verify_signature_sets([b"a"], lane="attestation") is True
        alone = stage(pm, "lane_wait")
        assert alone["count"] == 1 and 0.15 <= alone["sum_s"] < 5.0
        # three at once leave together at the size trigger
        assert in_threads([lambda: d.verify_signature_sets([b"b"], lane="attestation")] * 3) \
            == [True] * 3
        # not admitted: a call that skips the queue observes nothing
        assert d.verify_signature_sets([b"c"], batchable=False) is True
    finally:
        d.close()
    assert stage(pm, "lane_wait")["count"] == 4


def test_traced_callers_get_one_lane_batch_event_each():
    pm = PipelineMetrics()
    sup = supervisor(MockBlsVerifier(result=False), SlowHost(False, 0.02), pm)
    d = lanes(sup, pm, max_sigs=3)
    roots = {}

    def traced(i):
        with spans.tracer.trace(f"gossip/test_{i}") as root:
            roots[i] = root
            return d.verify_signature_sets([bytes([i])], lane="attestation")

    try:
        verdicts = in_threads([lambda: traced(0), lambda: traced(1),
                               lambda: d.verify_signature_sets([b"u"], lane="attestation")])
    finally:
        d.close()
        sup.close()
    assert verdicts == [False, False, False]
    events = [[e for e in roots[i].events if e["name"] == "bls/lane_batch"] for i in (0, 1)]
    assert [len(e) for e in events] == [1, 1]
    a, b = events[0][0], events[1][0]
    assert a["batch"] == b["batch"] and a["sets"] == b["sets"] == 3
    assert a["lane_wait_s"] >= 0.0 and b["lane_wait_s"] >= 0.0
    # the batch's device call and its per-set pass each waited for the
    # dispatch thread; the host tier audited both refusals
    assert a["dispatch_wait_s"] == b["dispatch_wait_s"] >= 0.0
    assert a["audit_s"] == b["audit_s"] >= 0.04
    assert stage(pm, "dispatch_wait")["count"] == 2 and stage(pm, "audit")["count"] == 2


# -- the supervisor ------------------------------------------------------------------


def test_dispatch_wait_behind_a_slow_call_inline_zero_and_none_past_the_deadline():
    pm = PipelineMetrics()
    dev = HeldDevice()
    sup = supervisor(dev, pm=pm, deadline_s=30.0)
    try:
        first = threading.Thread(target=lambda: sup.verify_signature_sets([b"x"]), daemon=True)
        first.start()
        assert dev.started.wait(5.0)
        second = threading.Thread(target=lambda: sup.verify_signature_sets([b"y"]), daemon=True)
        second.start()
        time.sleep(0.3)  # the second call queues behind the held one
        dev.release.set()
        first.join(10.0)
        second.join(10.0)
        assert not first.is_alive() and not second.is_alive()
    finally:
        sup.close()
    waits = stage(pm, "dispatch_wait")
    assert waits["count"] == 2
    # the first call waited for nothing, the second for the held call
    assert 0.25 <= waits["sum_s"] <= dev.held_s + 0.05

    inline_pm = PipelineMetrics()
    inline = supervisor(MockBlsVerifier(), pm=inline_pm, deadline_s=0)
    assert inline.verify_signature_sets([b"x"]) is True
    assert inline.verify_signature_sets_individual([b"x", b"y"]) == [True, True]
    assert stage(inline_pm, "dispatch_wait") == {"sum_s": 0.0, "count": 2}

    late_pm = PipelineMetrics()
    late = supervisor(SlowHost(True, 0.3), pm=late_pm, deadline_s=0.05)
    try:
        with pytest.raises(DeviceDeadlineExceeded):
            late._device_call(lambda: late.device.verify_signature_sets([b"x"]), 1)
    finally:
        late.close()
    assert stage(late_pm, "dispatch_wait")["count"] == 0


@pytest.mark.parametrize("case", ["refused", "accepted", "device_raised"])
def test_audit_is_observed_and_scoped_only_for_a_negative_verdict(case):
    pm = PipelineMetrics()
    device = {"refused": MockBlsVerifier(result=False), "accepted": MockBlsVerifier(),
              "device_raised": Raising()}[case]
    sup = supervisor(device, SlowHost(False, 0.03), pm)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        verdict = sup.verify_signature_sets([b"x"])
    sup.close()
    names = {e.name for e in prof.events()}
    audit = stage(pm, "audit")
    if case == "refused":
        assert verdict is False and audit["count"] == 1 and audit["sum_s"] >= 0.03
        assert "bls/audit" in names
        assert sup.take_call_timings()["audit_s"] >= 0.03
    else:
        assert verdict is (case == "accepted") and audit["count"] == 0
        assert "bls/audit" not in names
        assert "audit_s" not in sup.take_call_timings()
    # the exception fallback keeps its own counter
    fallbacks = pm.supervisor_snapshot()["fallbacks"]
    assert fallbacks.get("exception", 0) == (case == "device_raised")


# -- lifecycle spans on an operator's profiler ---------------------------------------


def test_lifecycle_spans_reach_a_profiler_the_switch_did_not_start():
    tracer = spans.Tracer()
    assert spans._profiling_trace() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans._profiling_trace() is not None
        with tracer.trace("gossip/beacon_block"):
            with tracer.span("chain/bls_verify"):
                pass
    assert spans._profiling_trace() is None
    names = {e.name for e in prof.events()}
    assert {"lifecycle/gossip/beacon_block", "lifecycle/chain/bls_verify"} <= names
