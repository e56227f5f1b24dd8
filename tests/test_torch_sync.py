"""The port's sync (`lodestar_tpu_torch/sync/`) against the JAX package's,
on the CPU at the minimal preset with 64 validators: a producer chain
holding `tests/torch_chain.py`'s `PLAN` (phase0 blocks, then Altair
across two epoch boundaries) in each package, and a fresh node of each
that catches up through `RangeSync` over `LocalPeer` and the real wire
codec: equal heads, state roots and imported roots, both ways across the
packages (the port's `LocalPeer` reading the JAX `ReqRespHandlers`' bytes
and the reverse); `UnknownBlockSync.resolve` fetching a block's unknown
ancestors; `BackfillSync.sync_to_genesis` archiving the same history
below the head, a peer that serves a tampered segment blamed in both
packages, and rotated away from when an honest peer remains. Host-tier
verifiers (`CpuBlsVerifier`) on both sides."""

from types import SimpleNamespace

import pytest
import torch
import torch_chain

from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier as JCpuBlsVerifier
from lodestar_tpu.chain.chain import BeaconChain as JBeaconChain
from lodestar_tpu.db import BeaconDb as JBeaconDb
from lodestar_tpu.network.reqresp.handlers import ReqRespHandlers as JHandlers
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.sync import LocalPeer as JLocalPeer
from lodestar_tpu.sync import RangeSync as JRangeSync
from lodestar_tpu.sync import UnknownBlockSync as JUnknownBlockSync
from lodestar_tpu.sync.backfill import BackfillError as JBackfillError
from lodestar_tpu.sync.backfill import BackfillSync as JBackfillSync
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.chain.chain import BeaconChain
from lodestar_tpu_torch.db import BeaconDb
from lodestar_tpu_torch.network.reqresp.handlers import ReqRespHandlers
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.profile_network import _ForkBlocks
from lodestar_tpu_torch.sync import BatchStatus, LocalPeer, RangeSync, UnknownBlockSync
from lodestar_tpu_torch.sync.backfill import BackfillError, BackfillSync
from lodestar_tpu_torch.sync.peer import PeerError
from lodestar_tpu_torch.types import get_types

torch.set_num_threads(1)

SPE = MINIMAL.SLOTS_PER_EPOCH
PT, JT = get_types(MINIMAL), jget_types(JMINIMAL)


def _wire_types(config, by_fork, phase0):
    """The phase0 namespace with blocks decoded by their slot's fork (the
    handlers and peers of a chain that crosses Altair)."""
    return SimpleNamespace(**{**vars(phase0),
                              "SignedBeaconBlock": _ForkBlocks(config, by_fork)})


class Side:
    """One package's producer chain, a fresh-node factory and its sync
    classes."""

    def __init__(self, name, config, genesis, blocks):
        self.name, self.config = name, config
        port = name == "port"
        self.t = PT if port else JT
        self.chain_cls = BeaconChain if port else JBeaconChain
        self.verifier = CpuBlsVerifier if port else JCpuBlsVerifier
        self.handlers_cls = ReqRespHandlers if port else JHandlers
        self.peer_cls = LocalPeer if port else JLocalPeer
        self.range_cls = RangeSync if port else JRangeSync
        self.unknown_cls = UnknownBlockSync if port else JUnknownBlockSync
        self.backfill_cls = BackfillSync if port else JBackfillSync
        self.backfill_err = BackfillError if port else JBackfillError
        self.db_cls = BeaconDb if port else JBeaconDb
        self.wire = _wire_types(config, self.t.by_fork, self.t.phase0)
        self.genesis = genesis
        self.blocks = blocks
        self.producer = self.fresh()
        for signed in blocks:
            self.producer.clock.set_slot(int(signed.message.slot))
            self.producer.process_block(signed)
        self.handlers = self.handlers_cls(config, self.wire, self.producer)

    def fresh(self):
        chain = self.chain_cls(self.config, self.t.phase0, self.genesis.copy(),
                               verifier=self.verifier())
        chain.clock.set_slot(int(self.blocks[-1].message.slot))
        return chain


@pytest.fixture(scope="module")
def sides():
    plan = torch_chain.port_chain()
    jconfig, jgen = torch_chain.jax_genesis()
    port = Side("port", plan.config, plan.genesis.state, plan.blocks)
    jax = Side("jax", jconfig, jgen.state,
               [torch_chain.to_jax(b, "SignedBeaconBlock") for b in plan.blocks])
    yield {"port": port, "jax": jax}
    port.producer.close()


def _range_sync(side, peer):
    node = side.fresh()
    rs = side.range_cls(node, side.wire, SPE, metrics=None)
    rs.add_peer(peer)
    head = rs.sync_to(int(side.blocks[-1].message.slot))
    return node, head


def _view(node):
    return {"head": node.head_root, "slot": int(node.head_state.state.slot),
            "state_root": node.head_state.hash_tree_root(), "blocks": sorted(node.blocks),
            "finalized": node.finalized_checkpoint, "justified": node.justified_checkpoint}


def test_range_sync_matches_jax(sides):
    """Each package's fresh node range-syncs from its own producer: equal
    heads, state roots and imported roots, the producer's."""
    views = {}
    for name, side in sides.items():
        peer = side.peer_cls("producer", side.handlers, side.wire)
        assert int(peer.status().head_slot) == int(side.blocks[-1].message.slot)
        node, head = _range_sync(side, peer)
        views[name] = _view(node)
        assert head == int(side.blocks[-1].message.slot)
        assert node.head_root == side.producer.head_root
        if name == "port":
            node.close()
    assert views["port"] == views["jax"]
    assert views["port"]["head"] == sides["port"].blocks[-1].message.hash_tree_root()


@pytest.mark.parametrize("direction", ["port_from_jax", "jax_from_port"])
def test_local_peer_crosses_packages(sides, direction):
    """The port's `LocalPeer` over the JAX handlers' wire bytes (and the
    reverse) syncs the node to the same head as within one package."""
    me, them = ("port", "jax") if direction == "port_from_jax" else ("jax", "port")
    side, other = sides[me], sides[them]
    peer = side.peer_cls("other", other.handlers, side.wire)
    node, head = _range_sync(side, peer)
    try:
        assert head == int(side.blocks[-1].message.slot)
        assert node.head_root == side.producer.head_root == other.producer.head_root
        assert node.head_state.hash_tree_root() == other.producer.head_state.hash_tree_root()
    finally:
        if me == "port":
            node.close()


def test_range_sync_batches_and_rotation(sides):
    """A peer that always fails is rotated away from (both packages); the
    port's batches end Processed, and metrics see every state."""
    class Flaky:
        peer_id = "flaky"

        def __init__(self, err):
            self.err = err

        def beacon_blocks_by_range(self, start_slot, count):
            raise self.err("always down")

    from lodestar_tpu.sync.peer import PeerError as JPeerError

    class Gauges:
        def __init__(self):
            self.states = {}
            self.processed = 0

        def __getattr__(self, name):
            return self

        def set(self, value, state):
            self.states[state] = value

        def inc(self, *args, **kwargs):
            self.processed += 1

        def observe(self, *args, **kwargs):
            pass

    heads = {}
    for name, side in sides.items():
        node = side.fresh()
        metrics = Gauges()
        rs = side.range_cls(node, side.wire, SPE, metrics=metrics)
        rs.add_peer(Flaky(PeerError if name == "port" else JPeerError))
        rs.add_peer(side.peer_cls("good", side.handlers, side.wire))
        heads[name] = (rs.sync_to(int(side.blocks[-1].message.slot)), node.head_root)
        assert metrics.states.get(BatchStatus.PROCESSED.value) == 2  # slots 1-16, then 17
        assert metrics.states.get(BatchStatus.FAILED.value) == 0
        if name == "port":
            node.close()
    assert heads["port"] == heads["jax"]


def test_unknown_block_sync_resolves_parents(sides):
    """A block whose ancestors the node lacks: both packages fetch them by
    root and import the same chain."""
    out = {}
    for name, side in sides.items():
        node = side.fresh()
        ub = side.unknown_cls(node, side.wire)
        ub.add_peer(side.peer_cls("producer", side.handlers, side.wire))
        target = side.blocks[4]  # slot 10: four unknown ancestors
        root = ub.resolve(target)
        out[name] = (root, _view(node))
        assert root in node.blocks and node.head_root == root
        if name == "port":
            node.close()
    assert out["port"] == out["jax"]


def _tampering(peer_cls):
    class Tampering(peer_cls):
        def beacon_blocks_by_range(self, start_slot, count):
            blocks = super().beacon_blocks_by_range(start_slot, count)
            if blocks:
                blocks[0].signature = b"\x13" * 96
            return blocks

    return Tampering


@pytest.mark.parametrize("peers", ["honest", "tampering", "tampering_then_honest"])
def test_backfill_matches_jax(sides, peers):
    """Backfill from the producer's head block and state: both packages
    archive the same blocks below the anchor (proposer signatures checked
    by the host tier); a peer serving a tampered segment alone is blamed
    with BackfillError in both; with an honest peer after it, both rotate
    and archive the same history."""
    out = {}
    for name, side in sides.items():
        head = side.producer
        anchor = head.blocks[head.head_root]
        db = side.db_cls(side.t.phase0)
        bf = side.backfill_cls(side.config, side.t.phase0, db, anchor, head.head_state.state,
                               side.verifier(), terminal_root=None)
        if peers != "honest":
            bf.add_peer(_tampering(side.peer_cls)("evil", side.handlers, side.wire))
        if peers != "tampering":
            bf.add_peer(side.peer_cls("honest", side.handlers, side.wire))
        if peers == "tampering":
            with pytest.raises(side.backfill_err):
                bf.sync_to_genesis()
            out[name] = None
            continue
        archived = bf.sync_to_genesis()
        roots = [b.message.hash_tree_root() for b in db.block_archive.values_stream()]
        out[name] = (archived, bf.oldest_slot, roots)
        assert archived == len(side.blocks) - 1
    assert out["port"] == out["jax"]
