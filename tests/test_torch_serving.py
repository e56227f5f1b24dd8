"""The port's serving entry (`node/bls_stack.py`, `metrics/server.py`,
`warmup.py`) on the CPU:

- `build_bls_stack(device="cpu")` on a 16-set grouped job (a (4, 4)
  configuration, one real CPU verdict): the lanes return the host tier's
  verdict, the epoch table is filled by the daemon thread, and no pubkey
  is decompressed on the verdict path once it is;
- the metrics server on an ephemeral port answers every endpoint;
- `warmup` runs a one-rung ladder (the 4-set bucket) and marks
  `serving_ready` (the verdicts there come from a stand-in device that
  asks the host tier: the ladder's wiring is under test, not the maths);
- `close()` leaves no thread of the stack;
- the composed defaults equal the JAX env registry's.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from lodestar_tpu.testing import faults
from lodestar_tpu.utils.env import REGISTRY
from lodestar_tpu_torch import native
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.metrics.bls import FAMILIES
from lodestar_tpu_torch.node.bls_stack import build_bls_stack
from lodestar_tpu_torch.observability import compile_ledger, slo
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier
from lodestar_tpu_torch.profile_verdict import make_sets

torch.set_num_threads(1)

STACK_THREADS = ("bls-lane-worker", "bls-canary", "bls-device-dispatch", "epoch-table-fill")


def stack_threads(before):
    """The stack-named threads alive now that were not in `before` (the JAX
    package's supervisor names its dispatch thread alike, and an earlier
    test in the process may leave one of those draining)."""
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(STACK_THREADS) and t not in before)


@pytest.fixture(scope="module")
def served():
    """One stack, one epoch population, one 16-set grouped job through the
    lanes, then every endpoint read; closed at the end."""
    sets = make_sets(4, 4, seed=41, threads=2)
    host = CpuBlsVerifier().verify_signature_sets_individual(sets)
    before = set(threading.enumerate())
    stack = build_bls_stack(device="cpu", grouped_configs=((4, 4),),
                            pk_grouped_configs=((4, 4),), rng=np.random.default_rng(3),
                            metrics_port=0, dispatcher_args={"max_wait_ms": 20})
    out = {"stack": stack, "sets": sets, "host": host}
    try:
        # the first population waits until the second call is made, so that
        # call always finds it in flight, however the threads are scheduled
        gate, populate = threading.Event(), stack.supervisor.epoch_table_populate
        stack.supervisor.epoch_table_populate = lambda *a: gate.wait(60.0) and populate(*a)
        try:
            out["started"] = stack.populate_epoch_async(0, [s.pubkey.to_bytes() for s in sets])
            out["second_refused"] = not stack.populate_epoch_async(0, [])
        finally:
            gate.set()
        assert stack.wait_populated(60.0)
        del stack.supervisor.epoch_table_populate
        out["populate"] = dict(stack.last_populate)
        decompressions = []
        real = native.g1_decompress
        native.g1_decompress = lambda *a, **kw: decompressions.append(1) or real(*a, **kw)
        try:
            out["verdict"] = stack.verifier.verify_signature_sets(sets, lane="attestation")
        finally:
            native.g1_decompress = real
        out["decompressions"] = len(decompressions)
        out["planner"] = stack.pipeline.planner_snapshot()
        out["table"] = stack.supervisor.epoch_table_snapshot()
        server_threads = set(threading.enumerate()) - before
        port = stack.server.port
        docs = {}
        for route in ("/metrics", "/debug/breaker", "/debug/mesh", "/debug/fleet",
                      "/debug/lanes", "/debug/slo", "/debug/device", "/debug/epoch_table",
                      "/debug/compiles", "/debug/faults", "/debug/traces", "/nope"):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
                    body = r.read().decode()
                    docs[route] = (r.status, body if route == "/metrics" else json.loads(body))
            except urllib.error.HTTPError as e:
                docs[route] = (e.code, None)
        out["docs"] = docs
    finally:
        stack.close()
    out["left"] = [t for t in set(threading.enumerate()) - before
                   if t.is_alive() and not t.name.startswith("bls-marshal")]
    out["server_threads"] = server_threads
    out["before"] = before
    return out


def test_the_lanes_return_the_host_tiers_verdict(served):
    assert served["host"] == [True] * 16
    assert served["verdict"] is True
    assert served["planner"]["decisions"] == {"root_grouped": 1}


def test_the_epoch_table_is_filled_by_the_daemon_thread(served):
    assert served["started"] is True and served["second_refused"] is True
    assert served["populate"]["epoch"] == 0 and served["populate"]["rows"] == 16
    assert served["table"]["entries"][0]["rows"] == 16
    assert served["decompressions"] == 0
    assert served["planner"]["cache_events"].get("pk_miss", 0) == 16  # served by the table


def test_every_endpoint_answers(served):
    docs = served["docs"]
    status, text = docs["/metrics"]
    assert status == 200
    for _, _, name, _ in FAMILIES:
        assert f"# TYPE {name} " in text
    for prefix in ("lodestar_bls_lane_", "lodestar_bls_supervisor_", "lodestar_slo_"):
        assert f"# TYPE {prefix}" in text
    assert docs["/debug/breaker"][1]["state"] == "closed"
    assert docs["/debug/breaker"][1]["deadline_s"] == 120.0
    assert docs["/debug/mesh"][1] == {"wired": False}
    assert docs["/debug/fleet"][1] == {"wired": False}
    lanes = docs["/debug/lanes"][1]
    assert lanes["wired"] is True and lanes["batches"] == 1 and lanes["max_coalesce"] == 512
    assert "zero_block_sheds" in {o["name"] for o in docs["/debug/slo"][1]["objectives"]}
    assert docs["/debug/device"][1]["wired"] is True
    assert docs["/debug/epoch_table"][1]["wired"] is True
    assert "startup" in docs["/debug/compiles"][1]
    assert docs["/debug/faults"][0] == 404  # the stack has no faults object
    status, traces = docs["/debug/traces"]  # the process-wide lifecycle tracer
    assert status == 200 and traces["enabled"] is True and "traces" in traces
    assert docs["/nope"][0] == 404


def test_faults_endpoint_drives_the_injected_faults_object():
    from lodestar_tpu_torch.metrics.registry import MetricsRegistry
    from lodestar_tpu_torch.metrics.server import MetricsServer

    faults.clear(reset_counters=True)
    server = MetricsServer(MetricsRegistry(), port=0, faults=faults)
    server.start()
    url = f"http://127.0.0.1:{server.port}/debug/faults"
    try:
        with urllib.request.urlopen(url + "?set=flaky:0.5") as r:
            assert json.load(r)["modes"] == {"flaky": 0.5}
        with urllib.request.urlopen(url + "?clear=1") as r:
            assert json.load(r)["active"] is False
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "?set=bogus")
        assert e.value.code == 400
    finally:
        server.close()
        faults.clear(reset_counters=True)


def test_close_leaves_no_thread(served):
    assert served["left"] == []
    assert stack_threads(served["before"]) == []


def test_composed_defaults_are_the_jax_registrys(served):
    stack = served["stack"]
    sup, lanes = stack.supervisor, stack.verifier
    assert sup.deadline_s == REGISTRY["LODESTAR_TPU_DEVICE_DEADLINE"].default
    assert sup.failure_threshold == REGISTRY["LODESTAR_TPU_BREAKER_THRESHOLD"].default
    assert sup.cooldown_s == REGISTRY["LODESTAR_TPU_BREAKER_COOLDOWN"].default
    assert sup._retry_policy.max_attempts - 1 == REGISTRY["LODESTAR_TPU_DEVICE_RETRIES"].default
    assert sup.audit_negative is REGISTRY["LODESTAR_TPU_AUDIT_NEGATIVE"].default
    assert lanes.workers == REGISTRY["LODESTAR_TPU_LANE_WORKERS"].default
    assert lanes.max_coalesce == REGISTRY["LODESTAR_TPU_LANE_MAX_COALESCE"].default
    assert lanes.pending_cap == REGISTRY["LODESTAR_TPU_LANE_PENDING_CAP"].default
    assert lanes.waiter_timeout == REGISTRY["LODESTAR_TPU_WAITER_TIMEOUT"].default
    assert lanes._h2c_dedup is REGISTRY["LODESTAR_TPU_H2C_DEDUP"].default
    assert slo.POKE_INTERVAL_S == REGISTRY["LODESTAR_TPU_SLO_POKE_S"].default
    assert stack.device.max_sets_per_job == 128


def _host_device(monkeypatch):
    """TorchBlsVerifier's verdicts answered by the host tier."""
    cpu = CpuBlsVerifier()
    monkeypatch.setattr(TorchBlsVerifier, "verify_signature_sets",
                        lambda self, sets: cpu.verify_signature_sets(sets))
    monkeypatch.setattr(TorchBlsVerifier, "verify_signature_sets_individual",
                        lambda self, sets: cpu.verify_signature_sets_individual(sets))
    monkeypatch.setattr(TorchBlsVerifier, "_marshal", lambda self, sets, raw=False: list(sets))
    monkeypatch.setattr(TorchBlsVerifier, "verify_individual", lambda self, sets: torch.tensor(
        cpu.verify_signature_sets_individual(sets)))


def test_warmup_runs_a_one_rung_ladder_and_marks_serving_ready(monkeypatch):
    from lodestar_tpu_torch import warmup

    _host_device(monkeypatch)
    before = set(threading.enumerate())
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert warmup.main(["--device", "cpu", "--rungs", "bucket_4"]) == 0
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert doc["device"] == "cpu"
    assert set(doc["rung_seconds"]) == {"bucket_4"}
    assert "rung_bucket_4" in doc["marks"] and "serving_ready" in doc["marks"]
    assert doc["marks"]["rung_bucket_4"] <= doc["marks"]["serving_ready"]
    assert doc["serving_ready_seconds"] == compile_ledger.timeline().snapshot()["serving_ready_s"]
    assert "bls12_host" in doc["build_seconds"]
    assert doc["peak_device_bytes"] is None
    assert stack_threads(before) == []
    with pytest.raises(ValueError, match="unknown warm-boot rungs"):
        warmup.warm_production(TorchBlsVerifier(device="cpu"), rungs=["bucket_5"])
