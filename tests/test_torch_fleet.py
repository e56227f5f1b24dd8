"""The port's fleet slice (`parallel/fleet.py`, `parallel/fleet_host.py`
and the two-level pool of `parallel/mesh_pool.py` / `sharded.py`) against
the JAX package's `parallel/fleet.py` and the host tier.

Fast tier (CPU, ~1 min on one pytest worker):
- the port's `FleetRouter` equals the JAX one on every subnet's owner
  for 1-8 hosts and every rank, after each single eviction, on
  `snapshot()` and `slice_for`; its observer is told of every rebalance;
- `FleetTopology.parse` equals the JAX `from_env` over a table of knob
  values, `group_devices` equals the JAX one in emulation, the copied
  `ATTESTATION_SUBNET_COUNT` equals the JAX constant;
- the hub refuses a peer without the fleet's key and a topology without
  a key file does not listen;
- one module-scoped pool of four CPU workers (two emulated hosts of two,
  the (4, 4) grouped configuration, one row per worker) behind the
  port's `DeviceBlsVerifier(mesh=...)`: the raw grouped verdict of a
  valid batch and of one with a bad signature in host 1's rows, each
  equal to the host tier (`lodestar_tpu.native.bls_verify_sets`); the
  DCN-major worker order; host 1's workers killed, the next dispatch
  raises naming host 1; under the JAX `SupervisedBlsVerifier` that kill
  leads to `mesh_evict_host(1)` and a single-level retry with the host
  tier's verdict, and no fall back to the host tier.

Slow tier:
- each worker's per-host Fp12 product, per-host plane sums, totals and
  the gathered per-host products equal the JAX `_gather_fp12_partials` /
  `_combine_plane_sums` under `shard_map` on a (2, 2) ("dcn", "ici")
  slice of the CPU mesh, by canonical value;
- the two-level grouped, pk-grouped and bisection verdicts equal the
  single-level ones on the same batch;
- a `fleet_host` agent subprocess over loopback TCP with an authkey file
  serves host 1; its exit makes the next dispatch raise naming host 1.
"""

import os
import socket
import subprocess
import sys
import time
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client

import numpy as np
import pytest
import torch

from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu.chain.supervisor import SupervisedBlsVerifier
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipelineMetrics
from lodestar_tpu.params.constants import ATTESTATION_SUBNET_COUNT as JAX_SUBNETS
from lodestar_tpu.parallel import fleet as jax_fleet
from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
from lodestar_tpu_torch.observability.stages import PipelineMetrics
from lodestar_tpu_torch.parallel import fleet
from lodestar_tpu_torch.parallel.mesh import BlsMeshDispatcher
from lodestar_tpu_torch.parallel.mesh_pool import MeshWorkerError
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier
from test_torch_sharded import host_tier, make_sets, resign

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others (the pool's workers take one)
torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIG = (4, 4)  # (rows, lanes): one row per worker
DEVICES = ["cpu"] * 4
HOSTS = [[0, 1], [2, 3]]


# --- router, topology, constant -------------------------------------------------


def _owners(router):
    return [router.owner(s) for s in range(64)]


@pytest.mark.parametrize("hosts", range(1, 9))
def test_router_equals_the_jax_router(hosts):
    for rank in range(hosts):
        ours, theirs = fleet.FleetRouter(hosts, rank), jax_fleet.FleetRouter(hosts, rank)
        assert _owners(ours) == _owners(theirs)
        assert [ours.owns(s) for s in range(64)] == [theirs.owns(s) for s in range(64)]
        assert ours.snapshot() == theirs.snapshot()
        assert [ours.slice_for(r) for r in range(hosts)] == [
            theirs.slice_for(r) for r in range(hosts)]


@pytest.mark.parametrize("hosts", range(2, 9))
def test_router_equals_the_jax_router_after_each_eviction(hosts):
    for evicted in range(hosts):
        ours, theirs = fleet.FleetRouter(hosts, 0), jax_fleet.FleetRouter(hosts, 0)
        assert ours.evict_host(evicted) == theirs.evict_host(evicted)
        assert _owners(ours) == _owners(theirs)
        assert evicted not in _owners(ours)
        ours.record_foreign(3)
        theirs.record_foreign(3)
        assert ours.snapshot() == theirs.snapshot()
        assert ours.evict_host(evicted) is theirs.evict_host(evicted) is None
        assert ours.readmit_hosts() == theirs.readmit_hosts() == 1
        assert _owners(ours) == _owners(fleet.FleetRouter(hosts, 0))
        assert ours.snapshot() == theirs.snapshot()


def test_router_tells_its_observer_of_every_rebalance():
    class Recorder:
        def __init__(self):
            self.moved = []

        def fleet_rebalance(self, moved):
            self.moved.append(moved)

    rec = Recorder()
    router = fleet.FleetRouter(4, 1, observer=rec)
    moved = [router.evict_host(h) for h in (3, 2, 1, 0)]
    assert moved[3] is None  # the last host stays
    assert router.readmit_hosts() == 3 and router.readmit_hosts() == 0
    assert rec.moved == moved[:3] + [0]
    port_observer = PipelineMetrics()
    router = fleet.FleetRouter(2, 0, observer=port_observer)
    n = router.evict_host(1)
    assert port_observer.fleet_snapshot()["subnets_moved"] == n > 0


PARSE_TABLE = [
    (None, None, None),  # unset
    ("off", None, None),
    ("emulate", None, None),
    ("1", "4", "3"),
    ("h:1234", None, None),
    ("h:1234", "3", "2"),
    ("emulate", "2", "5"),  # a bad rank
    ("emulate", "1", None),  # one host
]


@pytest.mark.parametrize("spec,hosts,rank", PARSE_TABLE)
def test_parse_equals_the_jax_from_env(monkeypatch, spec, hosts, rank):
    for name, value in (("LODESTAR_TPU_FLEET", spec), ("LODESTAR_TPU_FLEET_HOSTS", hosts),
                        ("LODESTAR_TPU_FLEET_RANK", rank)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    theirs = jax_fleet.FleetTopology.from_env()
    ours = fleet.FleetTopology.parse(spec, None if hosts is None else int(hosts),
                                     None if rank is None else int(rank))
    fields = ("mode", "coordinator", "hosts", "rank")
    assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
    assert ours.active == theirs.active
    assert fleet.FleetTopology() == fleet.FleetTopology.parse(None)  # off by default


@pytest.mark.parametrize("hosts", range(1, 5))
def test_group_devices_equals_the_jax_one(hosts):
    ours = fleet.FleetTopology.parse("emulate", hosts)
    theirs = jax_fleet.FleetTopology(mode="emulate", hosts=hosts)
    for n in range(10):
        assert ours.group_devices(["cpu"] * n) == theirs.group_devices(list(range(n)))


def test_distributed_group_devices_follow_the_agents_ranks():
    topo = fleet.FleetTopology.parse("127.0.0.1:1", 3)
    devices = ["cuda:0", fleet.remote_device(2, "cuda:0"), "cuda:1",
               fleet.remote_device(1, "cuda:0"), fleet.remote_device(1, "cuda:1")]
    assert topo.group_devices(devices) == [[0, 2], [3, 4], [1]]
    assert topo.group_devices(["cuda:0", "cuda:1"]) is None  # no agent: one host
    assert fleet.split_device(devices[1]) == (2, "cuda:0")
    assert fleet.split_device("cuda:0") == (None, "cuda:0")


def test_subnet_count_equals_the_jax_constant():
    assert fleet.ATTESTATION_SUBNET_COUNT == JAX_SUBNETS == 64


def test_hub_refuses_a_peer_without_the_key(tmp_path):
    hub = fleet.FleetHub(("127.0.0.1", 0), b"the fleet's key", hosts=2)
    try:
        with pytest.raises(AuthenticationError):
            Client(hub.address, authkey=b"another key")
        c = Client(hub.address)  # no key: its first message fails the challenge
        c.send(("join", 1, ["cpu"], os.getpid()))
        with pytest.raises((EOFError, OSError)):
            while True:
                c.recv_bytes()
        c.close()
        agent = Client(hub.address, authkey=b"the fleet's key")
        agent.send(("join", 1, ["cpu", "cpu"], os.getpid()))
        assert hub.wait_agents(10)
        assert hub.refused == 2
        assert hub.devices() == ["host1/cpu", "host1/cpu"]
        agent.close()
        deadline = time.monotonic() + 10
        while hub.agent_alive(1) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert hub.missing() == [1]
    finally:
        hub.close()
    with pytest.raises(ValueError, match="authkey"):
        fleet.FleetHub(("127.0.0.1", 0), b"", hosts=2)
    no_key = fleet.FleetTopology.parse("127.0.0.1:0", 2)
    assert no_key.ensure_initialized(1) is False and no_key.hub is None
    empty = tmp_path / "key"
    empty.write_bytes(b"\n")
    assert fleet.FleetTopology.parse("127.0.0.1:0", 2, authkey_file=str(empty)) \
        .ensure_initialized(1) is False


# --- the four-worker two-level pool ----------------------------------------------


def grouped_batches():
    """16 sets over 4 roots (rows 0-3 of the (4, 4) layout, one per
    worker), valid and with a bad signature in row 3, host 1's second
    worker's."""
    valid = make_sets(range(16), [bytes([0x61 + i // 4]) * 32 for i in range(16)])
    return {"valid": valid, "bad_signature_host_1": resign(valid, 13, 99)}


@pytest.fixture(scope="module")
def served():
    """The module's two-level pool behind the port's facade, and its
    verdicts on both batches (computed once, before any test may kill a
    worker)."""
    batches = grouped_batches()
    d = BlsMeshDispatcher(DEVICES, observer=PipelineMetrics(), hosts=HOSTS)
    v = DeviceBlsVerifier(device="cpu", grouped_configs=(CONFIG,), mesh=d,
                          rng=np.random.default_rng(17))
    single = []
    kernels = v._inner._kernels
    inner = kernels["grouped_raw"]
    kernels["grouped_raw"] = lambda *a: single.append(1) or inner(*a)
    pool = d.start_pool()
    verdicts, hosts = {}, {}
    for name, sets in batches.items():
        before = dict(d.fleet_snapshot()["host_dispatches"])
        verdicts[name] = v.verify_signature_sets(sets)
        after = d.fleet_snapshot()["host_dispatches"]
        hosts[name] = {h: after[h] - before.get(h, 0) for h in after}
    yield dict(batches=batches, dispatcher=d, verifier=v, pool=pool, verdicts=verdicts,
               hosts=hosts, single=single, single_at_setup=len(single))
    v.close()
    assert not any(pool.alive())


@pytest.mark.parametrize("name", ["valid", "bad_signature_host_1"])
def test_two_level_grouped_raw_verdict_equals_the_host_tier(served, name):
    sets = served["batches"][name]
    assert served["verdicts"][name] is all(host_tier(sets)) is (name == "valid")
    assert served["hosts"][name] == {"0": 1, "1": 1}  # through the fleet, once
    assert served["single_at_setup"] == 0  # NOT_SHARDED never taken
    snap = served["dispatcher"].snapshot()
    assert snap["size"] == 4 and snap["compiled"] == ["grouped_raw:4x4@4/2hosts"]


def test_workers_are_dcn_major(served):
    pool = served["pool"]
    assert pool.layout == (("cpu", "cpu"), ("cpu", "cpu")) and pool.size == 4
    assert pool.places() == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert len(set(pool.pids)) == 4


def _kill_host_1(pool):
    for k in (2, 3):
        if pool.alive()[k]:
            pool.kill(k)


def test_killed_host_raises_naming_the_host(served):
    d, v, pool = served["dispatcher"], served["verifier"], served["pool"]
    if d.pool is not pool:
        pytest.skip("the module's pool was replaced by an earlier test")
    _kill_host_1(pool)
    t0 = time.monotonic()
    with pytest.raises(MeshWorkerError) as ei:
        v.verify_signature_sets(served["batches"]["valid"])
    assert time.monotonic() - t0 < pool.timeout_s
    assert ei.value.host == 1 and ei.value.chip == 2
    with pytest.raises(MeshWorkerError) as again:  # broken until an eviction
        v.verify_signature_sets(served["batches"]["valid"])
    assert again.value.host == 1


def test_jax_supervisor_evicts_the_killed_host(served):
    d, v, pool = served["dispatcher"], served["verifier"], served["pool"]
    _kill_host_1(pool)
    cpu = CpuBlsVerifier()
    cpu_calls = []
    cpu.verify_signature_sets = lambda sets: cpu_calls.append(len(sets)) or True
    sup = SupervisedBlsVerifier(v, cpu, observer=JaxPipelineMetrics(), deadline_s=0,
                                canary_thread=False)
    sets = served["batches"]["valid"]  # a False verdict would be audited by the CPU tier
    assert sup.verify_signature_sets(sets) is all(host_tier(sets)) is True
    assert cpu_calls == []  # served by the device tier, single-level
    snap = v.fleet_snapshot()
    assert snap["evicted_hosts"] == [{"host": 1, "reason": "MeshWorkerError"}]
    assert snap["hosts_serving"] == 1 and v.mesh_snapshot()["evicted"] == []
    assert d.pool.layout == (("cpu", "cpu"),) and not any(pool.alive())
    assert served["single"] == []  # never the single-device verdict
    assert sup.breaker_state == "closed"


# --- slow tier -------------------------------------------------------------------


def _canonical(np_limbs):
    from lodestar_tpu_torch.ops import fp

    return fp.canonical(torch.tensor(np.asarray(np_limbs))).numpy()


@pytest.mark.slow
def test_two_level_combines_equal_the_jax_shard_map(cpu_mesh):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from lodestar_tpu.ops import fp2 as jfp2
    from lodestar_tpu.ops import msm as jmsm
    from lodestar_tpu.ops.points import g2 as jg2
    from lodestar_tpu.parallel import sharded as jsh
    from lodestar_tpu.parallel.verifier import TpuBlsVerifier
    from lodestar_tpu_torch.parallel.verifier import _rand_pairs

    jv = TpuBlsVerifier(grouped_configs=(CONFIG,), mesh=None)
    sets = grouped_batches()["valid"]
    g = jv._marshal_grouped(sets, jv._plan_groups(sets))
    a_bits, b_bits = _rand_pairs(g.valid.shape, np.random.default_rng(19))
    args = (g.pk_x, g.pk_y, g.msg_x, g.msg_y, g.sig_x, g.sig_y, a_bits, b_bits, g.valid)
    axes = ("dcn", "ici")
    mesh = Mesh(np.asarray(cpu_mesh.devices).reshape(-1)[:4].reshape(2, 2), axes)

    def body(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid):
        f_loc, u_tot = jsh._grouped_local(axes, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y,
                                          a_bits, b_bits, valid)
        f_host = jsh._fp12_product_tree(lax.all_gather(f_loc, "ici"))
        n_loc = valid.size
        sig = (sig_x.reshape((n_loc,) + sig_x.shape[-2:]),
               sig_y.reshape((n_loc,) + sig_y.shape[-2:]), jfp2.one((n_loc,)))
        sig = jg2.select(valid.reshape(n_loc), sig, jg2.infinity((n_loc,)))
        bits = jnp.concatenate([a_bits, b_bits], axis=-1).reshape(n_loc, 64)
        u_host = jsh._combine_plane_sums(jmsm.masked_plane_sums(jg2, sig, bits), "ici")
        return (f_host[None, None], jnp.stack(u_host)[None, None],
                jsh._gather_fp12_partials(f_loc, axes), jnp.stack(u_tot))

    fn = jax.jit(jsh._shard_map(body, mesh=mesh, in_specs=(P(axes),) * 9,
                                out_specs=(P("dcn", "ici"), P("dcn", "ici"), P(), P())))
    f_host_ref, u_host_ref, f_all_ref, u_tot_ref = (np.asarray(x) for x in fn(
        *(jnp.asarray(x) for x in args)))

    d = BlsMeshDispatcher(DEVICES, observer=PipelineMetrics(), hosts=HOSTS)
    try:
        parts = d.start_pool().run("grouped_combine", args)
    finally:
        d.close()
    for k, (f_host, u_host, u_tot, f_all) in enumerate(parts):
        h, j = divmod(k, 2)
        if j == 0:  # each host's product on its first worker
            np.testing.assert_array_equal(_canonical(f_host), _canonical(f_host_ref[h, j]))
        else:
            assert f_host is None
        np.testing.assert_array_equal(_canonical(u_host), _canonical(u_host_ref[h, j]),
                                      err_msg=f"worker {k}: its host's plane sums")
        np.testing.assert_array_equal(_canonical(u_tot), _canonical(u_tot_ref),
                                      err_msg=f"worker {k}: the totals")
        if k == 0:  # one Fp12 per host, gathered on worker 0
            assert f_all.shape == (2, 2, 3, 2, 32)
            np.testing.assert_array_equal(_canonical(f_all), _canonical(f_all_ref))
        else:
            assert f_all is None


def pk_batches():
    """16 sets over 16 unique roots from 4 keys (the (4, 4) pk-grouped
    layout), valid and with one wrong message in row 3 (host 1)."""
    from lodestar_tpu.bls import api as bls

    valid = make_sets([i // 4 for i in range(16)], [bytes([0x71, i]) * 16 for i in range(16)])
    bad = list(valid)
    s = valid[14]
    bad[14] = bls.SignatureSet(pubkey=s.pubkey, message=bytes([0x7F]) * 32,
                               signature=s.signature)
    return {"valid": valid, "wrong_message_host_1": bad}


def bisect_batches():
    sets = make_sets(range(40, 48), [bytes([0x81, i]) * 16 for i in range(8)])
    bad = sets
    for k in (1, 6, 7):  # the 8 sets pad to 16 lanes: 1 on host 0, 6 and 7 on host 1
        bad = resign(bad, k, 98)
    return {"valid": sets, "three_invalid": bad}


@pytest.fixture(scope="module")
def two_pools():
    """A two-level dispatcher of four CPU workers and a single-level one
    of two."""
    pools = {"two_level": BlsMeshDispatcher(DEVICES, observer=PipelineMetrics(), hosts=HOSTS),
             "single_level": BlsMeshDispatcher(DEVICES[:2], observer=PipelineMetrics())}
    yield pools
    for d in pools.values():
        d.close()


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["grouped", "pk_grouped", "bisect"])
def test_two_level_verdicts_equal_the_single_level_ones(two_pools, kind):
    batches = {"grouped": grouped_batches, "pk_grouped": pk_batches,
               "bisect": bisect_batches}[kind]()
    got = {}
    for level, d in two_pools.items():
        v = TorchBlsVerifier(device="cpu", grouped_configs=(CONFIG,),
                             pk_grouped_configs=(CONFIG,), mesh=d,
                             rng=np.random.default_rng(23))
        calls = []
        for k in ("grouped_raw", "pk_grouped_raw", "bisect_tree"):
            inner = v._kernels[k]
            v._kernels[k] = lambda *a, _k=k, _f=inner: calls.append(_k) or _f(*a)
        for name, sets in batches.items():
            if kind == "bisect":
                got[level, name] = v.verify_signature_sets_individual(sets)
            else:
                got[level, name] = v.verify_signature_sets(sets)
        assert calls == []  # sharded, never the single-device verdict
    for name, sets in batches.items():
        want = host_tier(sets) if kind == "bisect" else all(host_tier(sets))
        assert got["two_level", name] == got["single_level", name] == want
    dispatches = two_pools["two_level"].fleet_snapshot()["host_dispatches"]
    assert dispatches["0"] == dispatches["1"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_agent_over_tcp_serves_host_1(tmp_path):
    """Host 1's two workers started by a `fleet_host` agent subprocess
    that joins over loopback TCP with the fleet's key: the two-level
    verdict equals the host tier's; the agent's exit makes the next
    dispatch raise naming host 1; a peer without the key is refused."""
    key = tmp_path / "fleet.key"
    key.write_bytes(os.urandom(32).hex().encode())
    coordinator = f"127.0.0.1:{_free_port()}"
    topo = fleet.FleetTopology.parse(coordinator, 2, 0, authkey_file=str(key))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    agent = subprocess.Popen(
        [sys.executable, "-m", "lodestar_tpu_torch.parallel.fleet_host", "--coordinator",
         coordinator, "--rank", "1", "--devices", "cpu,cpu", "--authkey-file", str(key)],
        cwd=REPO, env=env)
    d = None
    try:
        assert topo.ensure_initialized(120)
        devices = ["cpu", "cpu"] + topo.hub.devices()
        assert devices[2:] == ["host1/cpu", "host1/cpu"]
        d = BlsMeshDispatcher(devices, observer=PipelineMetrics(),
                              hosts=topo.group_devices(devices), hub=topo.hub)
        v = TorchBlsVerifier(device="cpu", grouped_configs=(CONFIG,), mesh=d,
                             rng=np.random.default_rng(29))
        pool = d.start_pool()
        assert pool.places() == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
        sets = grouped_batches()["bad_signature_host_1"]
        assert v.verify_signature_sets(sets) is all(host_tier(sets)) is False
        with pytest.raises(AuthenticationError):
            Client(topo.hub.address, authkey=b"not the key")
        agent.kill()
        agent.wait(30)
        with pytest.raises(MeshWorkerError) as ei:
            v.verify_signature_sets(sets)
        assert ei.value.host == 1
        assert d.evict_host(1, reason="agent gone") == 2
        assert v.verify_signature_sets(sets) is False  # host 0's single-level pool
        assert d.pool.layout == (("cpu", "cpu"),)
    finally:
        if d is not None:
            d.close()
        topo.hub.close()
        if agent.poll() is None:
            agent.kill()
        agent.wait(30)
