"""The port's sharded verdicts (`parallel/sharded.py`) over a real pool
of worker processes (`parallel/mesh_pool.py`), on the CPU: two workers,
each with one intra-op thread, running the plain versions of the kernels.

Fast tier:
- one module-scoped 2-worker pool behind `TorchBlsVerifier(mesh=...)` at
  the (2, 4) grouped configuration (2 rows, one per worker): the raw
  grouped verdict of a valid batch and of one with a bad signature in the
  second worker's row, each equal to the host tier
  (`lodestar_tpu.native.bls_verify_sets`), dispatched once each through
  the mesh and never through the single-device kernel;
- a worker of that pool killed while idle: the next dispatch raises
  within the pool's timeout, attributed to that chip; `mesh_evict` brings
  the serving size to 1 and stops the pool (no process left), and the
  verdict is the single-device one, equal to the sharded verdict;
- the JAX `SupervisedBlsVerifier` over the port's
  `DeviceBlsVerifier(mesh=...)`: a killed worker makes it evict that chip
  and serve the retry single-device, with the host tier's verdict and no
  host-tier fallback.

Slow tier (each a few minutes on the CPU):
- the pk-grouped twin (raw and limb), the grouped limb twin, the
  bisection twin over 8 sets (three invalid, on both workers: the vector
  equals the host tier's) and the flat twin;
- a hung (stopped) worker: the dispatch raises after the collective
  timeout, blaming the hung worker and not its peer, and `close()` kills
  it;
- each worker's (f_loc, u_planes) of the grouped and pk-grouped local
  bodies, limb for limb against the JAX `_grouped_local` /
  `_pk_grouped_local` under `shard_map` on a 2-device slice of the CPU
  mesh.
"""

import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu.chain.supervisor import SupervisedBlsVerifier
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipelineMetrics
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
from lodestar_tpu_torch.observability.stages import PipelineMetrics
from lodestar_tpu_torch.parallel import sharded
from lodestar_tpu_torch.parallel import verifier as pv
from lodestar_tpu_torch.parallel.mesh import BlsMeshDispatcher
from lodestar_tpu_torch.parallel.mesh_pool import MeshWorkerError
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier, _rand_bits, _rand_pairs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others (the pool's workers take one)
torch.set_num_threads(1)

CONFIG = (2, 4)  # (rows, lanes): one row per worker
DEVICES = ["cpu", "cpu"]


def make_sets(keys, roots):
    out = []
    for k, root in zip(keys, roots):
        sk = bls.interop_secret_key(k)
        out.append(bls.SignatureSet(pubkey=sk.to_public_key(), message=root,
                                    signature=jnative.bls_sign(sk.to_bytes(), root, DST_G2)[1]))
    return out


def resign(sets, k, key):
    """Set k with its message signed by another key: a bad signature."""
    out = list(sets)
    sk = bls.interop_secret_key(key)
    out[k] = bls.SignatureSet(pubkey=sets[k].pubkey, message=sets[k].message,
                              signature=jnative.bls_sign(sk.to_bytes(), sets[k].message,
                                                         DST_G2)[1])
    return out


def host_tier(sets) -> list[bool]:
    return list(jnative.bls_verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), bls.DST_G2,
    ))


def grouped_batches():
    """8 sets over 2 roots (rows 0 and 1 of the (2, 4) layout), valid and
    with a bad signature in row 1, the second worker's."""
    valid = make_sets(range(8), [bytes([0x21 + i // 4]) * 32 for i in range(8)])
    return {"valid": valid, "bad_signature_worker_2": resign(valid, 5, 99)}


def spy_single_device(monkeypatch, v):
    """Count the single-device grouped and pk-grouped verdict calls."""
    calls = []
    for kind in ("grouped", "grouped_raw", "pk_grouped", "pk_grouped_raw", "bisect_tree"):
        inner = v._kernels[kind]
        monkeypatch.setitem(v._kernels, kind,
                            lambda *a, _k=kind, _f=inner: calls.append(_k) or _f(*a))
    return calls


@pytest.fixture(scope="module")
def served():
    """The module's pool behind a verifier, and its sharded verdicts on
    both batches (computed once, in order, before any test may kill a
    worker)."""
    batches = grouped_batches()
    d = BlsMeshDispatcher(DEVICES, observer=PipelineMetrics())
    v = TorchBlsVerifier(device="cpu", grouped_configs=(CONFIG,), mesh=d,
                         rng=np.random.default_rng(7), observer=PipelineMetrics())
    single = []
    inner = v._kernels["grouped_raw"]
    v._kernels["grouped_raw"] = lambda *a: single.append(1) or inner(*a)
    pool = d.start_pool()
    verdicts, dispatches = {}, {}
    for name, sets in batches.items():
        before = d.snapshot()["dispatches"]
        verdicts[name] = v.verify_signature_sets(sets)
        dispatches[name] = d.snapshot()["dispatches"] - before
    yield dict(batches=batches, dispatcher=d, verifier=v, pool=pool, verdicts=verdicts,
               dispatches=dispatches, single=single, single_at_setup=len(single),
               stages=v.observer.stage_snapshot())
    v.close()
    assert not any(pool.alive())


@pytest.mark.parametrize("name", ["valid", "bad_signature_worker_2"])
def test_sharded_grouped_raw_verdict_equals_the_host_tier(served, name):
    sets = served["batches"][name]
    assert served["verdicts"][name] is all(host_tier(sets)) is (name == "valid")
    assert served["dispatches"][name] == 1  # through the mesh, once
    assert served["single_at_setup"] == 0  # NOT_SHARDED never taken
    snap = served["dispatcher"].snapshot()
    assert snap["size"] == 2 and snap["compiled"] == ["grouped_raw:2x4@2"]


def test_sharded_verdicts_time_the_first_workers_device_stages(served):
    """Worker 0's host seconds per device scope come back with its reply
    and go to the verifier's observer: once per stage per verdict (the
    raw grouped verdict opens no scalar multiplication), inside the
    controller's dispatch stage."""
    stages = served["stages"]
    assert {k: v["count"] for k, v in stages.items() if k.startswith("bls/")} == {
        "bls/g2_decompress": 2, "bls/msm_planes": 2, "bls/miller_loop": 2,
        "bls/product_tree": 2, "bls/final_exp_batch": 2, "bls/plane_subgroup": 2}
    device = sum(v["sum_s"] for k, v in stages.items() if k.startswith("bls/"))
    assert 0 < device <= stages["dispatch"]["sum_s"]


def test_pool_workers_are_processes_of_their_own(served):
    pool = served["pool"]
    assert pool.devices == ("cpu", "cpu") and pool.size == 2
    assert len(set(pool.pids)) == 2 and all(pool.alive())
    counts = pool.counts()
    assert len(counts) == 2 and all(set(c) >= {"K1", "K4", "K2p", "K3-fe"} for c in counts)
    assert all(c["K2p"] == 0 for c in counts)  # CPU tensors launch no kernel


def test_killed_worker_raises_then_eviction_serves_single_device(served):
    d, v, pool = served["dispatcher"], served["verifier"], served["pool"]
    name = "bad_signature_worker_2"
    sets = served["batches"][name]
    pool.kill(1)
    t0 = time.monotonic()
    with pytest.raises(MeshWorkerError) as ei:
        v.verify_signature_sets(sets)
    assert time.monotonic() - t0 < pool.timeout_s
    assert ei.value.chip == 1
    # still broken: the next dispatch raises too, until the eviction
    with pytest.raises(MeshWorkerError):
        v.verify_signature_sets(sets)
    assert v.mesh_evict(1, reason="killed") == 1
    assert d.size == 1 and not d.enabled and d.pool is None
    assert not any(pool.alive())
    got = v.verify_signature_sets(sets)
    assert len(served["single"]) == 1  # the single-device kernel, once
    assert got is served["verdicts"][name] is all(host_tier(sets))


def test_jax_supervisor_evicts_the_killed_chip():
    valid = grouped_batches()["valid"]
    d = BlsMeshDispatcher(DEVICES, observer=PipelineMetrics())
    device = DeviceBlsVerifier(device="cpu", grouped_configs=(CONFIG,), mesh=d,
                               rng=np.random.default_rng(8))
    cpu = CpuBlsVerifier()
    cpu_calls = []
    cpu.verify_signature_sets = lambda sets: cpu_calls.append(len(sets)) or True
    sup = SupervisedBlsVerifier(device, cpu, observer=JaxPipelineMetrics(), deadline_s=0,
                                canary_thread=False)
    try:
        pool = d.start_pool()
        pool.kill(1)
        assert sup.verify_signature_sets(valid) is True
        assert cpu_calls == []  # served by the device tier, single-device
        snap = device.mesh_snapshot()
        assert [e["chip"] for e in snap["evicted"]] == [1]
        assert snap["evicted"][0]["reason"] == "MeshWorkerError"
        assert sup.breaker_state == "closed"
        assert d.pool is None and not any(pool.alive())
    finally:
        device.close()


def test_close_leaves_no_worker():
    d = BlsMeshDispatcher(DEVICES, observer=PipelineMetrics())
    pool = d.start_pool()
    assert all(pool.alive())
    d.close()
    assert not any(pool.alive()) and d.pool is None
    assert [p for p in mp.active_children() if p in pool._procs] == []


# --- slow tier ---------------------------------------------------------------


def pk_batches():
    """8 sets over 8 unique roots from 2 keys (the (2, 4) pk-grouped
    layout), valid and with one wrong message in row 1."""
    valid = make_sets([i % 2 for i in range(8)], [bytes([0x31, i]) * 16 for i in range(8)])
    bad = list(valid)
    s = valid[5]
    bad[5] = bls.SignatureSet(pubkey=s.pubkey, message=bytes([0x3F]) * 32, signature=s.signature)
    return {"valid": valid, "wrong_message": bad}


@pytest.fixture(scope="module")
def slow_pool():
    d = BlsMeshDispatcher(DEVICES, observer=PipelineMetrics())
    yield d
    d.close()


@pytest.mark.slow
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "limb"])
def test_sharded_pk_grouped_verdicts(slow_pool, monkeypatch, raw):
    v = TorchBlsVerifier(device="cpu", grouped_configs=(CONFIG,), pk_grouped_configs=(CONFIG,),
                         mesh=slow_pool, rng=np.random.default_rng(9))
    v._device_decompress = raw
    single = spy_single_device(monkeypatch, v)
    for name, sets in pk_batches().items():
        assert v._plan_groups(sets) is None and v._plan_pk_groups(sets)[:2] == CONFIG
        assert v.verify_signature_sets(sets) is all(host_tier(sets)) is (name == "valid")
    assert single == []
    kind = "pk_grouped_raw" if raw else "pk_grouped"
    assert f"{kind}:2x4@2" in slow_pool.snapshot()["compiled"]


@pytest.mark.slow
def test_sharded_grouped_limb_verdicts(slow_pool, monkeypatch):
    v = TorchBlsVerifier(device="cpu", grouped_configs=(CONFIG,), mesh=slow_pool,
                         rng=np.random.default_rng(10))
    v._device_decompress = False
    single = spy_single_device(monkeypatch, v)
    for name, sets in grouped_batches().items():
        assert v.verify_signature_sets(sets) is all(host_tier(sets)) is (name == "valid")
    assert single == []


@pytest.mark.slow
def test_sharded_bisection_equals_the_host_tier(slow_pool, monkeypatch):
    sets = make_sets(range(20, 28), [bytes([0x41, i]) * 16 for i in range(8)])
    for k in (1, 5, 7):  # the 8 sets pad to 16 lanes: 1 and 5 on the first worker, 7 too
        sets = resign(sets, k, 98)
    v = TorchBlsVerifier(device="cpu", mesh=slow_pool, rng=np.random.default_rng(11))
    single = spy_single_device(monkeypatch, v)
    got = v.verify_signature_sets_individual(sets)
    assert got == host_tier(sets) == [k not in (1, 5, 7) for k in range(8)]
    assert single == [] and v.last_bisect["rounds"] > 0
    assert "bisect:16@2" in slow_pool.snapshot()["compiled"]


@pytest.mark.slow
def test_hung_worker_raises_within_the_collective_timeout():
    """A stopped (hung) worker: its peer's gather times out after the
    pool's collective timeout and the dispatch raises, blaming the hung
    worker, not the peer; close() kills it."""
    import os
    import signal

    from lodestar_tpu_torch.parallel.mesh_pool import MeshPool

    pool = MeshPool(DEVICES)
    try:
        os.kill(pool.pids[1], signal.SIGSTOP)
        lanes = 4  # an all-padding bisection batch: 2 lanes per worker
        arrays = (np.zeros((lanes, 32), np.int32), np.zeros((lanes, 32), np.int32),
                  *(np.zeros((lanes, 2, 32), np.int32) for _ in range(4)),
                  np.zeros((lanes, 64), np.int32), np.zeros((lanes,), bool))
        t0 = time.monotonic()
        with pytest.raises(MeshWorkerError, match="Timed out") as ei:
            pool.run("bisect", arrays)
        assert pool.timeout_s <= time.monotonic() - t0 < 3 * pool.timeout_s
        assert ei.value.chip == 1
    finally:
        pool.close()
    assert not any(pool.alive())


@pytest.mark.slow
def test_sharded_flat_twin():
    sets = make_sets(range(30, 38), [bytes([0x51, i]) * 16 for i in range(8)])
    v = TorchBlsVerifier(device="cpu", mesh=None)
    flat = sharded.ShardedBlsVerifier(DEVICES)
    try:
        for name, batch in (("valid", sets), ("bad_signature", resign(sets, 6, 97))):
            arrs = v._marshal(batch)  # 16 lanes, 8 of them padding
            r_bits = _rand_bits(arrs.pk_x.shape[0], np.random.default_rng(12))
            assert flat.verify_arrays(arrs, r_bits) is all(host_tier(batch)) is (name == "valid")
    finally:
        flat.close()


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["grouped", "pk_grouped"])
def test_local_bodies_equal_the_jax_shard_map(slow_pool, cpu_mesh, kind):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from lodestar_tpu.parallel import sharded as jsh
    from lodestar_tpu.parallel.verifier import TpuBlsVerifier

    jv = TpuBlsVerifier(grouped_configs=(CONFIG,), pk_grouped_configs=(CONFIG,), mesh=None)
    if kind == "grouped":
        sets = grouped_batches()["valid"]
        g = jv._marshal_grouped(sets, jv._plan_groups(sets))
        local = jsh._grouped_local
    else:
        sets = pk_batches()["valid"]
        g = jv._marshal_pk_grouped(sets, jv._plan_pk_groups(sets))
        local = jsh._pk_grouped_local
    a_bits, b_bits = _rand_pairs(g.valid.shape, np.random.default_rng(13))
    args = (g.pk_x, g.pk_y, g.msg_x, g.msg_y, g.sig_x, g.sig_y, a_bits, b_bits, g.valid)

    mesh2 = Mesh(np.asarray(cpu_mesh.devices).reshape(-1)[:2], ("dp",))

    def body(*xs):
        f_loc, u = local("dp", *xs)
        return f_loc[None], u

    fn = jax.jit(jsh._shard_map(body, mesh=mesh2, in_specs=(P("dp"),) * 9,
                                out_specs=(P("dp"), P())))
    f_ref, u_ref = fn(*(jnp.asarray(x) for x in args))
    f_ref = np.asarray(f_ref)
    u_ref = np.stack([np.asarray(c) for c in u_ref])

    parts = sharded.local_parts(slow_pool.start_pool(), kind, g, g.sig_x, g.sig_y, a_bits, b_bits)
    for k, (f_loc, u_planes) in enumerate(parts):
        np.testing.assert_array_equal(f_loc, f_ref[k], err_msg=f"worker {k} f_loc")
        np.testing.assert_array_equal(u_planes, u_ref, err_msg=f"worker {k} u_planes")
