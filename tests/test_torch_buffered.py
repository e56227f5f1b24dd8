"""The port's batching facades and host tier (`chain/bls_verifier.py`)
against the JAX package's: `_verify_merged`, `ThreadBufferedVerifier` and
`BufferedVerifier` over the same scripted verifier (the same per-request
verdicts, calls, metric families and counters), and `CpuBlsVerifier` on
16 real sets, valid and with two tampered, set for set."""

import asyncio
import threading

import pytest

from lodestar_tpu import native as jax_native
from lodestar_tpu.chain import bls_verifier as jax_bv
from lodestar_tpu.metrics.beacon import create_beacon_metrics
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipeline
from lodestar_tpu_torch.bls.api import SignatureSet
from lodestar_tpu_torch.chain import bls_verifier as port_bv
from lodestar_tpu_torch.metrics.bls import FAMILIES, create_bls_metrics
from lodestar_tpu_torch.observability.stages import PipelineMetrics as PortPipeline
from lodestar_tpu_torch.profile_verdict import make_sets

SIDES = {"jax": (jax_bv, JaxPipeline, lambda: create_beacon_metrics()),
         "port": (port_bv, PortPipeline, lambda: create_bls_metrics())}


class Scripted:
    """Batch verdict False when any set is in `bad`; per-set verdicts by
    membership. Records every call."""

    def __init__(self, bad=()):
        self.bad = set(bad)
        self.calls = []
        self._lock = threading.Lock()

    def verify_signature_sets(self, sets):
        with self._lock:
            self.calls.append(("batch", list(sets)))
        return not any(s in self.bad for s in sets)

    def verify_signature_sets_individual(self, sets):
        with self._lock:
            self.calls.append(("individual", list(sets)))
        return [s not in self.bad for s in sets]


def families(prom) -> dict:
    """The seven facade families as (attribute → exposition lines)."""
    text = prom.registry.expose().splitlines()
    out = {}
    for attr, _, name, _ in FAMILIES:
        out[attr] = [ln for ln in text if ln.split("{")[0].split(" ")[0].startswith(name)
                     and not ln.startswith("#")]
    return out


def without_wait(fam: dict) -> dict:
    """The buffer-wait histogram's bucket counts depend on the clock."""
    return {k: v for k, v in fam.items() if k != "bls_buffer_wait_seconds"}


GROUPS = [["a", "b"], ["c"], ["d", "e", "f"]]


@pytest.mark.parametrize("bad", [(), ("e",), ("a", "c")])
def test_verify_merged(bad):
    out = {}
    for side, (mod, _, prom_fn) in SIDES.items():
        v = Scripted(bad)
        prom = prom_fn()
        metrics = {"batches": 0, "sigs_verified": 0, "batch_fallbacks": 0}
        verdicts = mod._verify_merged(v, GROUPS, metrics, prom)
        out[side] = (verdicts, v.calls, metrics, families(prom))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [not any(s in bad for s in g) for g in GROUPS]


@pytest.mark.parametrize("bad", [(), ("d",)])
def test_thread_buffered_verifier(bad):
    """Three threads' calls merge at the size threshold into one batch;
    a non-batchable call goes straight through."""
    out = {}
    for side, (mod, pipeline, prom_fn) in SIDES.items():
        v = Scripted(bad)
        prom = prom_fn()
        p = pipeline()
        tb = mod.ThreadBufferedVerifier(v, max_sigs=6, max_wait_ms=10_000, prom=prom,
                                        pipeline=p)
        results = {}
        threads = [threading.Thread(target=lambda g=g: results.__setitem__(
            g[0], tb.verify_signature_sets(g))) for g in GROUPS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        direct = tb.verify_signature_sets(["z"], batchable=False)
        delegated = tb.bad  # __getattr__ reaches the wrapped verifier
        flushes = [ln for ln in p.registry.expose().splitlines()
                   if ln.startswith("lodestar_bls_verifier_flushes_total")]
        calls = sorted((kind, sorted(sets)) for kind, sets in v.calls)
        out[side] = (results, direct, delegated, calls, tb.metrics, without_wait(families(prom)),
                     flushes)
    assert out["port"] == out["jax"]
    assert out["port"][0] == {g[0]: not any(s in bad for s in g) for g in GROUPS}


def test_async_buffered_verifier():
    async def drive(mod, pipeline, prom):
        v = Scripted(("c",))
        bv = mod.BufferedVerifier(v, prom=prom, pipeline=pipeline)
        got = await asyncio.gather(*(bv.verify(g, batchable=True) for g in GROUPS))
        direct = await bv.verify(["z"])
        return got, direct, v.calls, bv.metrics

    out = {}
    for side, (mod, pipeline, prom_fn) in SIDES.items():
        prom = prom_fn()
        got = asyncio.run(drive(mod, pipeline(), prom))
        out[side] = got + (without_wait(families(prom)),)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True, False, True]


def test_mock_verifier():
    for result in (True, False):
        j, p = jax_bv.MockBlsVerifier(result), port_bv.MockBlsVerifier(result)
        assert p.verify_signature_sets([1, 2]) == j.verify_signature_sets([1, 2])
        assert (p.verify_signature_sets_individual([1, 2, 3])
                == j.verify_signature_sets_individual([1, 2, 3]))
        assert p.sets_seen == j.sets_seen == 5


@pytest.fixture(scope="module")
def real_sets():
    sets = make_sets(4, 4, seed=77, threads=2)
    bad = list(sets)
    for i, j in ((2, 9), (9, 2)):  # two sets carry each other's signatures
        bad[i] = SignatureSet(sets[i].pubkey, sets[i].message, sets[j].signature)
    return sets, bad


@pytest.mark.skipif(not jax_native.HAVE_NATIVE_BLS, reason="the JAX host tier is not built")
def test_cpu_tier_against_the_jax_one(real_sets):
    sets, bad = real_sets
    jax_cpu, port_cpu = jax_bv.CpuBlsVerifier(), port_bv.CpuBlsVerifier()
    for batch in (sets, bad):
        assert port_cpu.verify_signature_sets(batch) == jax_cpu.verify_signature_sets(batch)
        assert (port_cpu.verify_signature_sets_individual(batch)
                == jax_cpu.verify_signature_sets_individual(batch))
    assert port_cpu.verify_signature_sets(sets) is True
    assert port_cpu.verify_signature_sets(bad) is False
    assert port_cpu.verify_signature_sets_individual(bad) == [i not in (2, 9) for i in range(16)]
    assert port_cpu.verify_signature_sets([]) is False
    assert port_cpu.verify_signature_sets_individual([]) == []


def test_cpu_tier_refuses_what_its_native_route_refuses(real_sets):
    """A 95-byte signature or a 47-byte pubkey: the JAX tier hands the set
    to its Python oracle; the port has none and answers False for that
    set, the others keep their verdicts."""
    from lodestar_tpu_torch.bls.api import PublicKey

    sets, _ = real_sets
    odd = list(sets[:4])
    odd[1] = SignatureSet(odd[1].pubkey, odd[1].message, odd[1].signature[:95])
    odd[3] = SignatureSet(PublicKey(odd[3].pubkey.to_bytes()[:47]), odd[3].message,
                          odd[3].signature)
    cpu = port_bv.CpuBlsVerifier()
    assert cpu.verify_signature_sets(odd) is False
    assert cpu.verify_signature_sets_individual(odd) == [True, False, True, False]
