"""The port's `DeviceBlsVerifier` facade (`chain/bls_verifier.py`) under
the JAX package's serving stack, which imports no JAX:
`SupervisedBlsVerifier` and `BlsLaneDispatcher` over the port, as over
the JAX facade.

- Real CPU verdicts (three, at the (2, 4) configuration): the dispatcher
  on a valid batch and the supervisor on a tampered one and on the
  tampered sets one by one give the host tier's verdicts, with the JAX
  `PipelineMetrics` injected: its stage, planner and bisect snapshots
  fill on the grouped and the individual path, and the dispatcher's
  `warm_h2c` seam reaches the port's hash cache.
- The kernels stubbed, each path (root-grouped, pk-grouped, flat, split,
  individual; verdict True and False): a recording observer sees the same
  calls, in the same order, from the port as from the JAX package's
  `TpuBlsVerifier` with its kernels stubbed the same way.
- `lodestar_tpu.testing.faults` injected: `exception` raises
  `InjectedFault` through the port (and the supervisor then serves the
  host tier's verdict); `flaky` turns True into False.
- The mesh and fleet seams answer as the JAX verifier does without a
  mesh; the facade chunks by `max_sets_per_job`, counts a batch that
  device decompression cannot take, and names each job in the profiler.
"""

import contextlib

import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu.chain.dispatcher import BlsLaneDispatcher
from lodestar_tpu.chain.supervisor import SupervisedBlsVerifier
from lodestar_tpu.observability.stages import PipelineMetrics
from lodestar_tpu.parallel.verifier import TpuBlsVerifier
from lodestar_tpu.testing import faults
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
from lodestar_tpu_torch.observability.stages import NULL_OBSERVER
from lodestar_tpu_torch.parallel import verifier as pv

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

CONFIG = ((2, 4),)  # (rows, lanes) of both grouped verdicts
ROOTS = [bytes([0x40 + i]) * 32 for i in range(16)]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear(reset_counters=True)
    yield
    faults.clear(reset_counters=True)


def make_sets(keys, roots):
    sets = []
    for k, root in zip(keys, roots):
        sk = bls.interop_secret_key(k)
        sets.append(bls.SignatureSet(
            pubkey=sk.to_public_key(), message=root,
            signature=jnative.bls_sign(sk.to_bytes(), root, DST_G2)[1],
        ))
    return sets


def grouped_sets():
    """8 sets over 2 roots: the (2, 4) grouped layout."""
    return make_sets(range(8), [ROOTS[i // 4] for i in range(8)])


def swap_messages(sets, i, j):
    out = list(sets)
    out[i] = bls.SignatureSet(pubkey=sets[i].pubkey, message=sets[j].message,
                              signature=sets[i].signature)
    out[j] = bls.SignatureSet(pubkey=sets[j].pubkey, message=sets[i].message,
                              signature=sets[j].signature)
    return out


def host_tier(sets) -> list[bool]:
    return list(jnative.bls_verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), bls.DST_G2,
    ))


class Recorder:
    """Records every observer call the verifiers make (timings left out)."""

    def __init__(self):
        self.events = []

    def stage(self, name):
        self.events.append(("stage", name))
        return contextlib.nullcontext()

    def observe_stage(self, name, seconds):
        self.events.append(("observe_stage", name))

    def planner(self, path, n_sets, group_sizes=None):
        self.events.append(("planner", path, n_sets, tuple(group_sizes or ())))

    def cache_event(self, cache, hit, n=1):
        self.events.append(("cache_event", cache, hit, n))

    def epoch_table_event(self, hit, n=1):
        self.events.append(("epoch_table_event", hit, n))

    def epoch_table_occupancy(self, rows):
        self.events.append(("epoch_table_occupancy", rows))

    def epoch_table_eviction(self, n=1):
        self.events.append(("epoch_table_eviction", n))

    def bisect(self, rounds, probes):
        self.events.append(("bisect", rounds, probes))

    def device_busy_sample(self, busy_s):
        self.events.append(("device_busy_sample",))

    def decompress_fallback(self, n=1):
        self.events.append(("decompress_fallback", n))


def _levels(n, zeros):
    m = 1 << max(0, (n - 1).bit_length())
    levels = []
    while True:
        levels.append(zeros(m))
        if m == 1:
            return levels
        m //= 2


def stub_port(monkeypatch, inner, verdict):
    """Every device dispatch of the port answers `verdict`; marshalling,
    planning and bisection still run."""
    ret = lambda *a, **kw: torch.tensor(verdict)  # noqa: E731
    for name in ("grouped_verify_kernel_raw", "pk_grouped_verify_kernel_raw",
                 "batch_verify_kernel_raw", "batch_verify_kernel"):
        monkeypatch.setattr(pv, name, ret)
    zeros = lambda m: torch.zeros((m, 2, 3, 2, 32), dtype=torch.int32)  # noqa: E731
    inner.verify_bisect_tree = lambda arrs, r: (torch.tensor(verdict),
                                                _levels(arrs.valid.shape[0], zeros))
    inner.probe_nodes = lambda fs: torch.full((fs.shape[0],), verdict)
    inner.verify_individual = lambda arrs: torch.full(arrs.valid.shape, verdict)


def stub_jax(v, verdict):
    """The JAX verifier's kernels stubbed the same way (its BatchVerifier
    seam, as tests/test_supervisor.py stubs it)."""
    k = v.kernels
    ret = lambda *a, **kw: np.bool_(verdict)  # noqa: E731
    for name in ("verify_batch", "verify_batch_raw", "verify_grouped", "verify_grouped_raw",
                 "verify_pk_grouped", "verify_pk_grouped_raw"):
        setattr(k, name, ret)
    zeros = lambda m: np.zeros((m, 2, 3, 2, 32), np.int32)  # noqa: E731
    k.verify_bisect_tree = lambda arrs, r: (np.bool_(verdict), _levels(arrs.valid.shape[0], zeros))
    k.probe_nodes = lambda fs: np.full((fs.shape[0],), verdict)
    k.verify_individual = lambda arrs, *a, **kw: np.full(arrs.valid.shape, verdict)


def _facade(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("grouped_configs", CONFIG)
    kw.setdefault("pk_grouped_configs", CONFIG)
    return DeviceBlsVerifier(**kw)


# --- the serving stack over the port, real CPU verdicts ----------------------


@pytest.fixture(scope="module")
def served():
    """One facade with `PipelineMetrics` injected, under the supervisor
    and the lane dispatcher: three real verdicts and what they left."""
    pm = PipelineMetrics()
    dev = DeviceBlsVerifier(device="cpu", grouped_configs=CONFIG, observer=pm,
                            rng=np.random.default_rng(5))
    sup = SupervisedBlsVerifier(dev, CpuBlsVerifier(), deadline_s=900.0, retries=0,
                                audit_negative=False, canary_thread=False)
    disp = BlsLaneDispatcher(sup, max_sigs=32, max_wait_ms=50, workers=1, pending_cap=0,
                             lane_caps={}, pipeline=PipelineMetrics())
    valid = grouped_sets()
    bad = swap_messages(valid, 1, 6)
    out = {"pm": pm, "dev": dev, "sup": sup, "valid": valid, "bad": bad}
    try:
        h2c_before = dev.h2c_cache_size()
        out["valid_verdict"] = disp.verify_signature_sets(valid, lane="aggregate")
        out["h2c_growth"] = dev.h2c_cache_size() - h2c_before
        out["planner_after_valid"] = pm.planner_snapshot()
        out["bad_verdict"] = sup.verify_signature_sets(bad)
        out["individual"] = sup.verify_signature_sets_individual(bad[:4])
        out["last_bisect"] = dict(dev._inner.last_bisect)
    finally:
        disp.close()
        sup.close()
    return out


def test_dispatcher_over_the_port_gives_the_host_tiers_verdict(served):
    assert served["valid_verdict"] is True
    assert all(host_tier(served["valid"]))
    # the root-grouped path ran (one 8-set decision), not a fallback
    assert served["planner_after_valid"]["decisions"] == {"root_grouped": 1}


def test_supervisor_over_the_port_rejects_the_tampered_batch(served):
    assert served["bad_verdict"] is False
    assert not all(host_tier(served["bad"]))


def test_individual_verdicts_equal_the_host_tier(served):
    assert served["individual"] == host_tier(served["bad"][:4])
    assert served["individual"] == [True, False, True, True]
    assert served["last_bisect"]["rounds"] > 0


def test_warm_h2c_seam_reaches_the_port(served):
    """The dispatcher hashes each unique root once through the port's
    cache before the verdict: two roots."""
    assert served["h2c_growth"] == 2


def test_pipeline_metrics_fill(served):
    pm = served["pm"]
    stages = pm.stage_snapshot()
    for name in ("marshal", "hash_to_curve", "rand", "dispatch", "device_wait", "bisect"):
        assert stages[name]["count"] >= 1, name
    planner = pm.planner_snapshot()
    assert planner["decisions"] == {"root_grouped": 2, "individual": 1}
    assert planner["sets"] == {"root_grouped": 16, "individual": 4}
    assert planner["cache_events"]["h2c_hit"] >= 1
    assert planner["cache_events"]["pk_miss"] >= 1
    bis = pm.bisect_snapshot()
    assert bis["batches"] == {"bisected": 1}
    assert bis["rounds"] == served["last_bisect"]["rounds"]
    assert bis["probes"] == served["last_bisect"]["probes"]
    assert bis["decompress_fallbacks"] == 0


def test_supervisor_mesh_lookups_get_no_mesh(served):
    sup = served["sup"]
    assert sup.mesh_evict(chip=0) is None
    assert sup.mesh_readmit() == 0
    assert sup.mesh_has_evicted() is False
    assert sup.mesh_snapshot() is None
    assert sup.mesh_evict_host(host=0) is None
    assert sup.fleet_snapshot() is None
    assert sup.fleet_attach_router(object()) is None
    assert sup._mesh_has_evicted() is False
    assert sup._evict_sick_chip(faults.InjectedChipFault(1), 8, "failure") is False
    assert sup._evict_sick_host(faults.InjectedHostFault(0), 8, "failure") is False
    assert "mesh" not in sup.breaker_snapshot()


# --- observer events against the JAX verifier, kernels stubbed ---------------


def _path_batches():
    return {
        "root_grouped": grouped_sets(),
        "pk_grouped": make_sets([i // 4 for i in range(8)], ROOTS[:8]),
        "flat": make_sets(range(3), ROOTS[:3]),
        "split": make_sets(list(range(4)) + [10, 11], [ROOTS[0]] * 4 + [ROOTS[5], ROOTS[6]]),
    }


@pytest.mark.parametrize("verdict", [True, False])
@pytest.mark.parametrize("path", ["root_grouped", "pk_grouped", "flat", "split", "individual"])
def test_observer_sees_what_the_jax_verifier_emits(monkeypatch, path, verdict):
    batches = _path_batches()
    sets = batches["flat" if path == "individual" else path]
    ours, theirs = Recorder(), Recorder()
    port = _facade(observer=ours)
    stub_port(monkeypatch, port._inner, verdict)
    jax_v = TpuBlsVerifier(grouped_configs=CONFIG, pk_grouped_configs=CONFIG,
                           observer=theirs, mesh=None)
    stub_jax(jax_v, verdict)
    if path == "individual":
        got = port.verify_signature_sets_individual(sets)
        want = jax_v.verify_signature_sets_individual(sets)
    else:
        got = port.verify_signature_sets(sets)
        want = jax_v.verify_signature_sets(sets)
    assert got == want
    assert ours.events == theirs.events
    paths = [e[1] for e in ours.events if e[0] == "planner"]
    expected = {"root_grouped": ["root_grouped"], "pk_grouped": ["pk_grouped"],
                "flat": ["per_set"], "split": ["split", "root_grouped", "per_set"],
                "individual": ["individual"]}[path]
    assert paths == expected


# --- fault injection ---------------------------------------------------------


def test_injected_exception_raises_through_the_port(monkeypatch):
    port = _facade(faults=faults)
    stub_port(monkeypatch, port._inner, True)
    faults.configure("exception:1.0")
    with pytest.raises(faults.InjectedFault):
        port.verify_signature_sets(grouped_sets())
    with pytest.raises(faults.InjectedFault):
        port.verify_signature_sets_individual(grouped_sets()[:3])
    assert faults.snapshot()["injected"]["exception"] == 2


def test_supervisor_serves_the_host_tier_under_injected_exceptions(monkeypatch):
    port = _facade(faults=faults)
    stub_port(monkeypatch, port._inner, False)  # the device would be wrong
    sup = SupervisedBlsVerifier(port, CpuBlsVerifier(), retries=0, canary_thread=False)
    faults.configure("exception:1.0")
    try:
        assert sup.verify_signature_sets(grouped_sets()) is True
    finally:
        sup.close()


def test_injected_flaky_turns_true_into_false(monkeypatch):
    port = _facade(faults=faults)
    stub_port(monkeypatch, port._inner, True)
    sets = grouped_sets()
    assert port.verify_signature_sets(sets) is True
    assert port.verify_signature_sets_individual(sets[:3]) == [True] * 3
    faults.configure("flaky:1.0")
    assert port.verify_signature_sets(sets) is False
    assert port.verify_signature_sets_individual(sets[:3]) == [False] * 3
    faults.clear()
    assert port.verify_signature_sets(sets) is True


def test_no_faults_object_calls_nothing(monkeypatch):
    port = _facade()
    stub_port(monkeypatch, port._inner, True)
    faults.configure("exception:1.0,flaky:1.0")  # armed, but not injected
    assert port.verify_signature_sets(grouped_sets()) is True
    assert faults.snapshot()["injected"] == {}


# --- the facade's own seams ----------------------------------------------------


def test_defaults_are_the_jax_facades():
    port = DeviceBlsVerifier(device="cpu")
    assert port.max_sets_per_job == 128
    assert port.observer is NULL_OBSERVER
    assert port._inner._device_decompress is True
    assert port._inner.grouped_configs == ((16, 8), (64, 64))
    assert port._inner.pk_grouped_configs == ((128, 32),)
    snap = port.epoch_table_snapshot()
    assert snap["enabled"] is True and snap["epochs_retained"] == 2
    assert snap["max_rows"] == 1 << 21
    assert port.h2c_cache_size() == 0


def test_chunks_by_max_sets_per_job():
    port = _facade(max_sets_per_job=3)
    seen = []
    port._inner.verify_signature_sets = lambda s: seen.append(len(s)) or True
    port._inner.verify_signature_sets_individual = lambda s: [len(s)] * len(s)
    sets = make_sets(range(7), ROOTS[:7])
    assert port.verify_signature_sets(sets) is True
    assert seen == [3, 3, 1]
    assert port.verify_signature_sets_individual(sets) == [3, 3, 3, 3, 3, 3, 1]
    assert port.verify_signature_sets([]) is False
    # a failing job stops the batch
    port._inner.verify_signature_sets = lambda s: seen.append(len(s)) or False
    seen.clear()
    assert port.verify_signature_sets(sets) is False
    assert seen == [3]


def test_decompress_fallback_is_counted(monkeypatch):
    rec = Recorder()
    port = _facade(observer=rec)
    stub_port(monkeypatch, port._inner, True)
    odd = make_sets([1], [b"\x11" * 40])  # a 40-byte message: host marshal
    assert port.verify_signature_sets(odd) is True
    assert port.verify_signature_sets(grouped_sets()) is True
    assert rec.events.count(("decompress_fallback", 1)) == 1


def test_each_job_is_a_profiler_scope(monkeypatch):
    port = _facade()
    stub_port(monkeypatch, port._inner, True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.verify_signature_sets(grouped_sets())
        port.verify_signature_sets_individual(grouped_sets()[:3])
    names = {e.key for e in prof.key_averages()}
    assert "bls_verify_batch/8" in names
    assert "bls_verify_individual/3" in names
