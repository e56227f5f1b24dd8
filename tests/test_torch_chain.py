"""The port's chain (`lodestar_tpu_torch/chain/chain.py` and its services)
against the JAX package's `BeaconChain`, exactly, on the CPU at the
minimal preset with 64 validators: `tests/torch_chain.py`'s `PLAN`
imported block by block through both (the JAX `CpuBlsVerifier`, the
port's `CpuBlsVerifier`), with equal heads, checkpoints, state roots,
fork-choice nodes, emitted events and unrealized checkpoints after each
block; the same blocks as one segment; the tampered and the orphan block
refused by both; a dev chain over four epochs in which both produce
byte-equal blocks from full attestations and finalize and archive alike;
the caches, pools, regen, clock, reprocess queue, db and light-client
server against their twins; and the port's defaults (the serving stack
on the GPU, which raises here; the import wait's bound as an argument)."""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch
import torch_chain

from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier as JCpuBlsVerifier
from lodestar_tpu.chain.chain import BeaconChain as JBeaconChain
from lodestar_tpu.chain.chain import BlockImportError as JBlockImportError
from lodestar_tpu.chain.emitter import ChainEvent as JChainEvent
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition.unrealized import (
    compute_unrealized_checkpoints as j_unrealized,
)
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.chain.chain import BeaconChain, BlockImportError
from lodestar_tpu_torch.chain.emitter import ChainEvent as PChainEvent
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition.unrealized import compute_unrealized_checkpoints
from lodestar_tpu_torch.types import get_types

torch.set_num_threads(1)

PT = get_types(MINIMAL).phase0
JT = jget_types(JMINIMAL).phase0
SPE = MINIMAL.SLOTS_PER_EPOCH


def chains(plan_chain, jax_chain_config=None):
    """A port and a JAX `BeaconChain` on the same genesis, each with an
    event log."""
    jconfig, jgen = torch_chain.jax_genesis(chain_config=jax_chain_config)
    port = BeaconChain(plan_chain.config, PT, plan_chain.genesis.state.copy(),
                       verifier=CpuBlsVerifier())
    jax = JBeaconChain(jconfig, JT, jgen.state.copy(), verifier=JCpuBlsVerifier())
    for chain, events in ((port, PChainEvent), (jax, JChainEvent)):
        chain.events = []
        for ev in events:
            chain.emitter.on(ev, lambda e, payload, log=chain.events:
                             log.append((e.value, dict(payload))))
    return port, jax


def fork_view(chain) -> dict:
    fc = chain.fork_choice
    nodes = [(n.slot, n.root, n.parent, n.state_root, n.justified_epoch, n.finalized_epoch,
              n.unrealized_justified_epoch, n.unrealized_finalized_epoch, n.execution_status,
              n.best_child, n.best_descendant) for n in fc.proto.nodes]
    s = fc.store
    return {"nodes": nodes, "weights": [int(w) for w in fc.proto.weights],
            "store": (s.current_slot, s.justified_checkpoint, s.finalized_checkpoint,
                      s.best_justified, s.unrealized_justified, s.unrealized_finalized),
            "boost": fc.proposer_boost_root}


def chain_view(chain, unrealized) -> dict:
    return {
        "head": chain.head_root,
        "justified": chain.justified_checkpoint,
        "finalized": chain.finalized_checkpoint,
        "state_root": chain.head_state.hash_tree_root(),
        "fork_choice": fork_view(chain),
        "events": list(chain.events),
        "unrealized": unrealized(chain.head_state, chain.types),
        "blocks": sorted(chain.blocks),
    }


@pytest.fixture(scope="module")
def plan_chain():
    return torch_chain.port_chain()


@pytest.fixture(scope="module")
def plan_views(plan_chain):
    """Both chains' views after each block of `PLAN`."""
    port, jax = chains(plan_chain)
    views = []
    for signed in plan_chain.blocks:
        slot = int(signed.message.slot)
        port.clock.set_slot(slot)
        jax.clock.set_slot(slot)
        port.events.clear()
        jax.events.clear()
        root = port.process_block(signed)
        jroot = jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
        views.append((root, jroot, chain_view(port, compute_unrealized_checkpoints),
                      chain_view(jax, j_unrealized)))
    yield views, port, jax
    port.close()


@pytest.mark.parametrize("k", range(len(torch_chain.PLAN)))
def test_plan_block_matches_jax(plan_views, plan_chain, k):
    views, _, _ = plan_views
    root, jroot, pv, jv = views[k]
    assert root == jroot == plan_chain.blocks[k].message.hash_tree_root()
    assert pv == jv
    assert pv["head"] == root and pv["state_root"] == bytes(plan_chain.blocks[k].message.state_root)
    assert [e for e, _ in pv["events"]][:2] == ["block", "head"]


def test_regen_and_checkpoint_states_match(plan_views, plan_chain):
    _, port, jax = plan_views
    root3 = plan_chain.blocks[2].message.hash_tree_root()
    for epoch in (1, 2):
        p = port.regen.get_checkpoint_state(epoch, root3)
        j = jax.regen.get_checkpoint_state(epoch, root3)
        assert p.hash_tree_root() == j.hash_tree_root()
        assert p.state.slot == epoch * SPE
    block = plan_chain.blocks[3].message
    assert port.regen.get_pre_state(block).hash_tree_root() == \
        jax.regen.get_pre_state(torch_chain.to_jax(plan_chain.blocks[3], "SignedBeaconBlock")
                                .message).hash_tree_root()
    # the replay path: forget block 3's post-state and rebuild it from block 2's
    for c in (port, jax):
        c.state_cache._head_state_root_by_block.pop(root3)
    assert port.regen.get_state_for_block(root3).hash_tree_root() == \
        jax.regen.get_state_for_block(root3).hash_tree_root()


def test_segment_matches_jax(plan_chain):
    port, jax = chains(plan_chain)
    try:
        blocks = plan_chain.blocks[:4]
        for c in (port, jax):
            c.clock.set_slot(int(blocks[-1].message.slot))
        roots = port.process_block_segment(blocks)
        jroots = jax.process_block_segment(
            [torch_chain.to_jax(b, "SignedBeaconBlock") for b in blocks])
        assert roots == jroots == [b.message.hash_tree_root() for b in blocks]
        assert chain_view(port, compute_unrealized_checkpoints) == chain_view(jax, j_unrealized)
    finally:
        port.close()


def test_tampered_and_orphan_blocks_refused_by_both(plan_chain):
    port, jax = chains(plan_chain)
    try:
        for signed in plan_chain.blocks[:3]:
            for c in (port, jax):
                c.clock.set_slot(int(signed.message.slot))
            port.process_block(signed)
            jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
        pre = plan_chain.factory.advance(plan_chain.posts[2], 9)
        bad = plan_chain.factory.swapped(pre, plan_chain.blocks[3], 1, 3)
        orphan = plan_chain.blocks[4]  # its parent (slot 9) is not imported
        for c in (port, jax):
            c.clock.set_slot(10)
        before = chain_view(port, compute_unrealized_checkpoints)
        for signed, what in ((bad, "signature"), (orphan, "unknown parent")):
            with pytest.raises(BlockImportError, match=what):
                port.process_block(signed)
            with pytest.raises(JBlockImportError, match=what):
                jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
        after = chain_view(port, compute_unrealized_checkpoints)
        assert after == before == chain_view(jax, j_unrealized)
    finally:
        port.close()


# --- the dev chain: produce, sign, import, attest --------------------------


def _attest_head(factory, config, chain, types):
    """Every committee of the head slot attests to the head (one full
    aggregate each), as the JAX dev-chain test does, signed by the host
    tier: the port's attestations."""
    from lodestar_tpu_torch.config.beacon_config import compute_signing_root
    from lodestar_tpu_torch.params import DOMAIN_BEACON_ATTESTER

    cached = chain.head_state
    state, slot = cached.state, cached.state.slot
    epoch, start = slot // SPE, (slot // SPE) * SPE
    target = chain.head_root if start == slot else \
        bytes(state.block_roots[start % MINIMAL.SLOTS_PER_HISTORICAL_ROOT])
    domain = config.get_domain(DOMAIN_BEACON_ATTESTER, slot, epoch)
    out = []
    for index in range(cached.epoch_ctx.get_committee_count_per_slot(epoch)):
        committee = [int(v) for v in cached.epoch_ctx.get_beacon_committee(slot, index)]
        data = types.AttestationData(
            slot=slot, index=index, beacon_block_root=chain.head_root,
            source=state.current_justified_checkpoint.copy(),
            target=types.Checkpoint(epoch=epoch, root=target))
        (sig,) = factory.sign_aggregate(
            [(committee, compute_signing_root(data.hash_tree_root(), domain))])
        out.append(types.Attestation(aggregation_bits=[True] * len(committee), data=data,
                                     signature=sig))
    return out


@pytest.fixture(scope="module")
def dev_run():
    """Four epochs of produced blocks through both chains, on phase0 (as
    the JAX package's own dev-chain test runs): both chains build their
    db from the phase0 types they are given, and finalization archives
    the finalized state with them."""
    from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
    from lodestar_tpu_torch import profile_block
    from lodestar_tpu_torch.config.beacon_config import compute_signing_root
    from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
    from lodestar_tpu_torch.params import DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO
    from lodestar_tpu_torch.state_transition.block import _epoch_signing_root
    from lodestar_tpu_torch.state_transition.stf import fork_types

    config, genesis, _ = profile_block.interop_chain(MINIMAL_CHAIN_CONFIG, MINIMAL,
                                                     torch_chain.N)
    factory = profile_block.BlockFactory(config, torch_chain.N, 2)
    port, jax = chains(torch_chain.Chain(config, genesis, factory), J_MINIMAL_CC)
    produced = []
    try:
        for slot in range(1, 4 * SPE + 1):
            port.clock.set_slot(slot)
            jax.clock.set_slot(slot)
            proposer = factory.advance(port.head_state, slot).epoch_ctx.get_beacon_proposer(slot)
            (reveal,) = factory.sign([(proposer, _epoch_signing_root(
                slot // SPE, config.get_domain(DOMAIN_RANDAO, slot)))])
            block = port.produce_block(slot, reveal)
            jblock = jax.produce_block(slot, reveal)
            (sig,) = factory.sign([(block.proposer_index, compute_signing_root(
                block.hash_tree_root(), config.get_domain(DOMAIN_BEACON_PROPOSER, slot)))])
            signed = fork_types(factory.advance(port.head_state, slot)).SignedBeaconBlock(
                message=block, signature=sig)
            produced.append((block.serialize(), jblock.serialize()))
            root = port.process_block(signed)
            jroot = jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
            assert root == jroot == port.head_root == jax.head_root
            for att in _attest_head(factory, config, port, PT):
                port.on_aggregated_attestation(att, att.data.hash_tree_root())
                jax.on_aggregated_attestation(torch_chain.to_jax(att, "Attestation"),
                                              att.data.hash_tree_root())
        yield port, jax, produced
    finally:
        port.close()
        factory.close()


def test_dev_chain_produces_byte_equal_blocks(dev_run):
    _, _, produced = dev_run
    assert len(produced) == 4 * SPE
    for k, (ours, theirs) in enumerate(produced):
        assert ours == theirs, f"slot {k + 1}"


def test_dev_chain_finalizes_and_archives_alike(dev_run):
    port, jax, _ = dev_run
    assert port.finalized_checkpoint == jax.finalized_checkpoint
    assert port.finalized_checkpoint[0] >= 2
    assert port.justified_checkpoint == jax.justified_checkpoint
    assert sorted(port.finalized_blocks) == sorted(jax.finalized_blocks) != []
    assert [v.serialize() for v in port.db.block_archive.values_stream()] == \
        [v.serialize() for v in jax.db.block_archive.values_stream()]
    assert chain_view(port, compute_unrealized_checkpoints) == chain_view(jax, j_unrealized)
    # the gossip aggregates of the last slot sit in both pools alike
    assert [a.serialize() for a in port.aggregated_pool.get_attestations_for_block(
        PT, port.head_state, 8)] == [a.serialize() for a in jax.aggregated_pool
                                     .get_attestations_for_block(JT, jax.head_state, 8)]


# --- the small services against their twins --------------------------------


def test_seen_caches_match():
    from lodestar_tpu.chain import seen_cache as js
    from lodestar_tpu_torch.chain import seen_cache as ps

    out = {}
    for mod in (js, ps):
        by_epoch, agg, prop, sync = (mod.SeenByEpoch(), mod.SeenAggregatedAttestations(),
                                     mod.SeenBlockProposers(), mod.SeenSyncCommitteeMessages())
        got, base = [], 0
        r = np.random.default_rng(3)
        for _ in range(300):
            e, i = base + int(r.integers(0, 3)), int(r.integers(0, 20))
            got.append(by_epoch.is_known(e, i))
            by_epoch.add(e, i)
            bits = [bool(b) for b in r.integers(0, 2, 6)]
            root = bytes([int(r.integers(0, 3))]) * 32
            got.append(agg.is_known_superset(root, bits))
            agg.add(e, root, bits)
            got.append(prop.is_known(e, i))
            prop.add(e, i)
            got.append(sync.is_known(e, i % 4, i))
            sync.add(e, i % 4, i)
            if r.random() < 0.05:
                base += 1
                by_epoch.prune(base)
                agg.prune(base)
                prop.prune(base)
                sync.prune(base)
        out[mod.__name__] = got
    assert out[js.__name__] == out[ps.__name__]
    assert 50 < sum(out[ps.__name__]) < len(out[ps.__name__])


def test_state_caches_match():
    from lodestar_tpu.chain import state_cache as js
    from lodestar_tpu_torch.chain import state_cache as ps

    out = {}
    for mod in (js, ps):
        sc, cp = mod.StateContextCache(max_states=3), mod.CheckpointStateCache(max_states=3)
        got = []
        r = np.random.default_rng(5)
        for step in range(200):
            k = bytes([int(r.integers(0, 6))]) * 32
            if r.random() < 0.5:
                sc.add(k, f"s{step}", block_root=k[::-1])
                cp.add(int(r.integers(0, 4)), k, f"c{step}")
            got += [sc.get(k), sc.get_by_block_root(k[::-1]), len(sc),
                    cp.get(int(r.integers(0, 4)), k), cp.get_latest(k, int(r.integers(0, 4)))]
            if r.random() < 0.05:
                cp.prune_finalized(int(r.integers(0, 4)))
        out[mod.__name__] = got
    assert out[js.__name__] == out[ps.__name__]


def test_attestation_pool_matches(plan_chain):
    """Unaggregated gossip attestations aggregate on insert alike (the
    port keeps the aggregate compressed)."""
    from lodestar_tpu.chain.op_pools import AttestationPool as JPool
    from lodestar_tpu_torch.chain.op_pools import AttestationPool

    factory = plan_chain.factory
    data = PT.AttestationData(slot=5, index=0, beacon_block_root=b"h" * 32,
                              source=PT.Checkpoint(), target=PT.Checkpoint())
    root = data.hash_tree_root()
    sigs = factory.sign([(i, b"m" * 32) for i in range(4)])
    atts = [PT.Attestation(aggregation_bits=[k == i for k in range(4)], data=data,
                           signature=sigs[i]) for i in range(4)]
    port, jax = AttestationPool(), JPool()
    outcomes = [(port.add(a, root), jax.add(torch_chain.to_jax(a, "Attestation"), root))
                for a in atts + atts[:2]]
    assert [p for p, _ in outcomes] == [j for _, j in outcomes] == \
        ["added", "aggregated", "aggregated", "aggregated", "already_known", "already_known"]
    _, bits, sig = port.get_aggregate(5, root)
    _, jbits, jsig = jax.get_aggregate(5, root)
    assert bits == jbits == [True] * 4
    assert sig.to_bytes() == jsig.to_bytes()
    (want,) = factory.sign_aggregate([(range(4), b"m" * 32)])
    assert sig.to_bytes() == want
    for pool in (port, jax):
        pool.prune(10)
    assert port.get_aggregate(5, root) is None and jax.get_aggregate(5, root) is None


def test_clock_reprocess_and_proposer_cache_match():
    from lodestar_tpu.chain import clock as jc
    from lodestar_tpu.chain import proposer_cache as jp
    from lodestar_tpu.chain import reprocess as jr
    from lodestar_tpu_torch.chain import clock as pc
    from lodestar_tpu_torch.chain import proposer_cache as pp
    from lodestar_tpu_torch.chain import reprocess as pr

    out = {}
    for c, p, r in ((jc, jp, jr), (pc, pp, pr)):
        now = [1000.0]
        clock = c.BeaconClock(1000, 6, 8, time_fn=lambda: now[0])
        manual = c.ManualClock(1000, 6, 8)
        rq = r.ReprocessController(time_fn=lambda: now[0])
        cache = p.BeaconProposerCache()
        got = []
        for t in np.random.default_rng(9).uniform(0, 200, 64):
            now[0] = 1000.0 + float(t)
            s = int(t) // 6
            manual.set_slot(s)
            got += [clock.current_slot, clock.current_epoch, clock.slot_with_gossip_disparity(),
                    clock.is_current_slot_given_disparity(s), round(clock.seconds_into_slot(), 9),
                    clock.time_at_slot(s), manual.current_slot,
                    rq.wait_for_block(bytes([s % 5]) * 32, s), rq.prune(30.0)]
            got.append(len(rq.on_block_imported(bytes([s % 7]) * 32)))
            cache.add(s // 8, s % 11, bytes([s % 256]) * 20)
            got.append(cache.get(s % 13))
            cache.prune(s // 8)
            got.append(len(cache))
        got.append(dict(rq.metrics))
        out[c.__name__] = got
    assert out[jc.__name__] == out[pc.__name__]


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_db_matches(kind, tmp_path, plan_chain):
    from lodestar_tpu.db import FileDb as JFileDb
    from lodestar_tpu.db import MemoryDb as JMemoryDb
    from lodestar_tpu.db import BeaconDb as JBeaconDb
    from lodestar_tpu_torch.db import BeaconDb, FileDb, MemoryDb

    def open_db(cls, name):
        return cls() if kind == "memory" else cls(str(tmp_path / name))

    pdb = open_db(MemoryDb if kind == "memory" else FileDb, "port")
    jdb = open_db(JMemoryDb if kind == "memory" else JFileDb, "jax")
    r = np.random.default_rng(11)
    got = {"port": [], "jax": []}
    for step in range(400):
        # keys under a prefix of their own, apart from the beacon buckets
        key = b"\xf0" + bytes(r.integers(0, 8, 3).astype(np.uint8))
        val = bytes([step % 256]) * 3
        op = r.integers(0, 4)
        for name, db in (("port", pdb), ("jax", jdb)):
            if op == 0:
                db.put(key, val)
            elif op == 1:
                db.delete(key)
            elif op == 2:
                db.batch_put([(key, val), (key + b"\x01", val)])
            got[name].append((db.get(key), list(db.keys_stream(b"\xf0\x00", b"\xf0\x04")),
                              list(db.values_stream(b"\xf0\x02", b"\xf0\x07"))))
    assert got["port"] == got["jax"]
    if kind == "file":  # reopened, the log replays to the same contents
        pdb.close()
        jdb.close()
        pdb, jdb = FileDb(str(tmp_path / "port")), JFileDb(str(tmp_path / "jax"))
        assert list(pdb.entries_stream(b"", b"\xff")) == list(jdb.entries_stream(b"", b"\xff"))
    # the beacon repositories over them: hot blocks and the archive
    pbeacon, jbeacon = BeaconDb(PT, pdb), JBeaconDb(JT, jdb)
    for signed in plan_chain.blocks[:3]:
        root = signed.message.hash_tree_root()
        j = torch_chain.to_jax(signed, "SignedBeaconBlock")
        pbeacon.block.put(root, signed)
        jbeacon.block.put(root, j)
        pbeacon.archive_block(signed)
        jbeacon.archive_block(j)
        assert pbeacon.get_archived_block_by_root(root).serialize() == \
            jbeacon.get_archived_block_by_root(root).serialize()
    assert list(pbeacon.block_archive.keys_stream()) == list(jbeacon.block_archive.keys_stream())
    assert [v.serialize() for v in pbeacon.block.values_stream()] == \
        [v.serialize() for v in jbeacon.block.values_stream()]
    pdb.close()
    jdb.close()


def test_light_client_server_matches(plan_chain):
    """The Altair blocks of `PLAN` through both servers (each block's
    sync aggregate signs its parent): equal updates and bootstraps."""
    from lodestar_tpu.light_client import LightClientServer as JServer
    from lodestar_tpu_torch.light_client import LightClientServer

    jconfig, _ = torch_chain.jax_genesis()
    port = LightClientServer(plan_chain.config, get_types(MINIMAL).altair, MINIMAL)
    jax = JServer(jconfig, jget_types(JMINIMAL).altair, JMINIMAL)
    blocks, posts = plan_chain.blocks, plan_chain.posts
    fed = 0
    for k in range(1, len(blocks)):
        if torch_chain.fork_of(blocks[k]) != "altair" or torch_chain.fork_of(blocks[k - 1]) != "altair":
            continue
        port.on_import_block(blocks[k], blocks[k - 1], posts[k - 1])
        jax.on_import_block(torch_chain.to_jax(blocks[k], "SignedBeaconBlock"),
                            torch_chain.to_jax(blocks[k - 1], "SignedBeaconBlock"),
                            torch_chain.jax_cached(jconfig, posts[k - 1]))
        fed += 1
        assert port.latest_optimistic_update.serialize() == \
            jax.latest_optimistic_update.serialize()
    assert fed >= 2
    assert [u.serialize() for u in port.get_updates(0, 4)] == \
        [u.serialize() for u in jax.get_updates(0, 4)] != []
    assert list(port._bootstrap_by_root) == list(jax._bootstrap_by_root)
    for boot_root in port._bootstrap_by_root:
        assert port.get_bootstrap(boot_root).serialize() == \
            jax.get_bootstrap(boot_root).serialize()


# --- the port's departures ----------------------------------------------------


def test_no_device_raises_without_cuda(plan_chain):
    """With no verifier the chain builds the port's serving stack on the
    GPU, and raises on this CUDA-less machine rather than serve from the
    CPU unasked."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BeaconChain(plan_chain.config, PT, plan_chain.genesis.state)


def test_device_cpu_builds_and_closes_its_stack(plan_chain):
    chain = BeaconChain(plan_chain.config, PT, plan_chain.genesis.state, device="cpu")
    stack = chain.bls_stack
    assert chain.bls is stack.verifier
    chain.close()
    assert chain.bls_stack is None
    with pytest.raises(RuntimeError, match="shutdown"):
        chain._verify_pool.submit(int)
    # a verifier the caller passed is the caller's to stop
    own = CpuBlsVerifier()
    chain = BeaconChain(plan_chain.config, PT, plan_chain.genesis.state, verifier=own)
    assert chain.bls_stack is None and chain.bls is own
    chain.close()


def _never() -> Future:
    return Future()


@pytest.mark.parametrize("timeout,raises", [(0.05, True), (0.0, False), (-1.0, False)])
def test_import_wait_bound_is_an_argument(plan_chain, monkeypatch, timeout, raises):
    """The bound JAX reads from LODESTAR_TPU_IMPORT_WAIT_TIMEOUT is the
    chain's `import_wait_timeout_s` (≤ 0 disables it); the variable is
    not read."""
    monkeypatch.setenv("LODESTAR_TPU_IMPORT_WAIT_TIMEOUT", "0.01")
    chain = BeaconChain(plan_chain.config, PT, plan_chain.genesis.state,
                        verifier=CpuBlsVerifier(), import_wait_timeout_s=timeout)
    try:
        if raises:
            with pytest.raises(BlockImportError, match="import wait timeout"):
                chain._bounded(_never(), "block_signature")
        else:
            done = Future()
            threading.Timer(0.1, done.set_result, (True,)).start()
            assert chain._bounded(done, "block_signature") is True
    finally:
        chain.close()
