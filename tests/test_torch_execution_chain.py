"""The port's post-merge chain against the JAX package's: a Capella
`BeaconChain` with every fork at genesis and the mock EL
(`execution.engine.ExecutionEngineMock`) in each package, on the minimal
preset with 16 interop validators (`torch_capella.capella_pair`, the JAX
`tests/test_execution_chain.py` fixture). Slot by slot, both chains
produce a block from the same pools (full sync contributions, a
BLS-to-execution change), the produced blocks must be byte-equal, and
the port's signature of it imports into both; heads, payload hashes,
the engines' heads, balances, withdrawal cursors and fork-choice nodes
(with their execution statuses) must agree. Then an invalid payload is
refused by both with the same invalidation, `prepare_next_slot` opens
the same building session, and `profile_capella.run` passes its checks
on the port's host verifier. Tolerance: bytes equal."""

import pytest
import torch
import torch_capella as tc

from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier as JCpuBlsVerifier
from lodestar_tpu.chain.chain import BeaconChain as JBeaconChain
from lodestar_tpu.execution.engine import ExecutionEngineMock as JExecutionEngineMock
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.chain.chain import BeaconChain, build_payload_attributes
from lodestar_tpu_torch.config.beacon_config import compute_signing_root
from lodestar_tpu_torch.execution.engine import ExecutionEngineMock
from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
    SYNC_COMMITTEE_SUBNET_COUNT,
    ForkName,
)
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import process_slots
from lodestar_tpu_torch.state_transition.capella import get_expected_withdrawals
from lodestar_tpu_torch.state_transition.block import _epoch_signing_root
from lodestar_tpu_torch.types import get_types

torch.set_num_threads(1)

SPE = tc.SPE
T = get_types(MINIMAL).capella
JT = jget_types(JMINIMAL).capella


class Pair:
    """The port's and the JAX package's Capella chains and engines."""

    def __init__(self):
        config, state, jconfig, jstate = tc.capella_pair()
        assert state.serialize() == jstate.serialize()
        self.config = config
        self.engine = ExecutionEngineMock(genesis_block_hash=tc.EL_GENESIS_HASH)
        self.jengine = JExecutionEngineMock(genesis_block_hash=tc.EL_GENESIS_HASH)
        self.port = BeaconChain(config, T, state.copy(), verifier=CpuBlsVerifier(),
                                execution_engine=self.engine)
        self.jax = JBeaconChain(jconfig, JT, jstate.copy(), verifier=JCpuBlsVerifier(),
                                execution_engine=self.jengine)

    def close(self):
        self.port.close()

    def set_slot(self, slot):
        for chain in (self.port, self.jax):
            if hasattr(chain.clock, "set_slot"):
                chain.clock.set_slot(slot)

    def randao(self, slot):
        pre = self.port.head_state.copy()
        if slot > pre.state.slot:
            process_slots(pre, T, slot)
        proposer = pre.epoch_ctx.get_beacon_proposer(slot)
        return tc.sk(proposer).sign(_epoch_signing_root(
            slot // SPE, self.config.get_domain(DOMAIN_RANDAO, slot))).to_bytes()

    def contributions(self, slot, block_root):
        """Full-participation sync contributions for `block_root` into both
        pools."""
        cached = self.port.head_state
        root = compute_signing_root(
            block_root, self.config.get_domain(DOMAIN_SYNC_COMMITTEE, slot, slot // SPE))
        index = cached.epoch_ctx.pubkey_to_index
        pubkeys = list(cached.state.current_sync_committee.pubkeys)
        size = MINIMAL.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        for sub in range(SYNC_COMMITTEE_SUBNET_COUNT):
            members = [index[bytes(pk)] for pk in pubkeys[sub * size:(sub + 1) * size]]
            agg = tc.bls.aggregate_signatures([tc.sk(v).sign(root) for v in members])
            contribution = T.SyncCommitteeContribution(
                slot=slot, beacon_block_root=block_root, subcommittee_index=sub,
                aggregation_bits=[True] * size, signature=agg.to_bytes())
            self.port.sync_contribution_pool.add(contribution)
            self.jax.sync_contribution_pool.add(
                JT.SyncCommitteeContribution.deserialize(contribution.serialize()))

    def change(self, index, address):
        signed = tc.signed_change(self.config, self.port.head_state, index, address)
        self.port.bls_changes_pool.add(signed)
        self.jax.bls_changes_pool.add(JT.SignedBLSToExecutionChange.deserialize(
            signed.serialize()))

    def produce(self, slot):
        """Both chains' block at `slot` from their pools; they must be equal."""
        self.set_slot(slot)
        randao = self.randao(slot)
        block = self.port.produce_block(slot, randao)
        jblock = self.jax.produce_block(slot, randao)
        assert block.serialize() == jblock.serialize()
        return block

    def sign(self, block):
        sig = tc.sk(block.proposer_index).sign(compute_signing_root(
            block.hash_tree_root(), self.config.get_domain(DOMAIN_BEACON_PROPOSER, block.slot)))
        return T.SignedBeaconBlock(message=block, signature=sig.to_bytes())

    def view(self, chain, engine):
        head = chain.head_state
        return {
            "head": chain.head_root,
            "state_root": head.hash_tree_root(),
            "payload_hash": bytes(head.state.latest_execution_payload_header.block_hash),
            "engine": (engine.head, engine.finalized, sorted(engine.payloads),
                       sorted(engine._building)),
            "balances": [int(b) for b in head.flat.balances],
            "cursors": (head.state.next_withdrawal_index,
                        head.state.next_withdrawal_validator_index),
            "nodes": [(n.slot, n.root, n.parent, n.execution_status)
                      for n in chain.fork_choice.proto.nodes],
        }

    def views(self):
        return self.view(self.port, self.engine), self.view(self.jax, self.jengine)


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


@pytest.fixture(scope="module")
def produced(pair):
    """One epoch of produced, signed and imported blocks; a change of
    validator 3's credential rides slot 2. Returns each slot's views."""
    records = []
    start_balance = int(pair.port.head_state.flat.balances[0])
    for slot in range(1, SPE + 1):
        pair.contributions(slot - 1, pair.port.head_root)
        if slot == 2:
            pair.change(3, b"\xcc" * 20)
        block = pair.produce(slot)
        assert bytes(block.body.execution_payload.block_hash) != b"\x00" * 32
        signed = pair.sign(block)
        root = pair.port.process_block(signed, verify_signatures=True)
        jroot = pair.jax.process_block(tc.to_jax(signed), verify_signatures=True)
        assert root == jroot == block.hash_tree_root()
        records.append((block, *pair.views()))
    return start_balance, records


@pytest.mark.parametrize("k", range(SPE))
def test_each_produced_slot_matches_jax(produced, k):
    _, records = produced
    block, view, jview = records[k]
    assert view == jview
    assert view["head"] == block.hash_tree_root()
    assert view["payload_hash"] == bytes(block.body.execution_payload.block_hash)
    assert view["engine"][0] == view["payload_hash"]
    # every imported block's payload was VALID at the engine
    assert [status for *_, status in view["nodes"][1:]] == ["valid"] * (k + 1)


def test_the_epoch_of_payload_blocks(pair, produced):
    start_balance, records = produced
    head = pair.port.head_state
    assert head.state.slot == SPE and head.fork == ForkName.capella
    assert int(head.flat.balances[0]) <= start_balance
    assert head.state.next_withdrawal_index > 0
    block = records[-1][0]
    assert all(block.body.sync_aggregate.sync_committee_bits)
    changed = [b for b, *_ in records if len(b.body.bls_to_execution_changes)]
    assert [int(b.slot) for b in changed] == [2]
    assert bytes(head.state.validators[3].withdrawal_credentials)[12:] == b"\xcc" * 20
    # the next payload builds on the head's, with the sweep's withdrawals
    attrs = build_payload_attributes(pair.config, head, T)
    assert attrs is not None and attrs[0] == bytes(
        head.state.latest_execution_payload_header.block_hash)
    assert [w.serialize() for w in attrs[1].withdrawals] == [
        w.serialize() for w in get_expected_withdrawals(head, T)]


def test_invalid_payload_rejected(pair, produced):
    slot = pair.port.head_state.state.slot + 1
    block = pair.produce(slot)
    signed = pair.sign(block)
    bad = bytes(block.body.execution_payload.block_hash)
    pair.engine.invalid_hashes.add(bad)
    pair.jengine.invalid_hashes.add(bad)
    head = pair.port.head_root
    try:
        with pytest.raises(Exception, match="payload invalid"):
            pair.port.process_block(signed, verify_signatures=True)
        with pytest.raises(Exception, match="payload invalid"):
            pair.jax.process_block(tc.to_jax(signed), verify_signatures=True)
    finally:
        pair.engine.invalid_hashes.clear()
        pair.jengine.invalid_hashes.clear()
    view, jview = pair.views()
    assert view == jview and view["head"] == head
    assert block.hash_tree_root() not in pair.port.blocks


def test_prepare_next_slot(pair, produced):
    slot = pair.port.head_state.state.slot
    for chain in (pair.port, pair.jax):
        chain.prepare_next_slot.on_slot(slot)
    prepared = pair.port.prepare_next_slot.get_prepared(slot + 1)
    jprepared = pair.jax.prepare_next_slot.get_prepared(slot + 1)
    assert prepared is not None and prepared.state.slot == slot + 1
    assert prepared.hash_tree_root() == jprepared.hash_tree_root()
    assert pair.engine._building and sorted(pair.engine._building) == sorted(
        pair.jengine._building)
    built = [(p.block_hash, p.parent_hash, p.timestamp, p.prev_randao,
              [w.serialize() for w in p.withdrawals]) for p in pair.engine._building.values()]
    jbuilt = [(p.block_hash, p.parent_hash, p.timestamp, p.prev_randao,
               [w.serialize() for w in p.withdrawals]) for p in pair.jengine._building.values()]
    assert built == jbuilt
    # the block produced from the prepared state imports as head in both
    block = pair.produce(slot + 1)
    signed = pair.sign(block)
    assert pair.port.process_block(signed) == pair.jax.process_block(tc.to_jax(signed))
    view, jview = pair.views()
    assert view == jview and view["head"] == block.hash_tree_root()
    assert pair.engine.head == bytes(block.body.execution_payload.block_hash)


def test_profile_capella_on_the_host_verifier():
    from lodestar_tpu_torch import profile_capella

    out = profile_capella.run(CpuBlsVerifier(), validators=64, preset=MINIMAL, log=lambda *a: None)
    assert out["failures"] == []
    steps = out["steps"]
    assert set(steps) >= {"upgrades", "slot1", "slot2", "tampered", "invalid_payload",
                          "prepare"}
    assert steps["slot1"]["sets"] == 3 + MINIMAL.MAX_BLS_TO_EXECUTION_CHANGES
    assert len(steps["slot2"]["withdrawals"]) == MINIMAL.MAX_WITHDRAWALS_PER_PAYLOAD


def _syncing_after(engine, slot_of, first_slot):
    """Make `engine` answer SYNCING (the optimistic import) for the
    payloads of blocks at `first_slot` and later, as an EL still syncing."""
    real = engine.notify_new_payload

    def notify(payload):
        status = real(payload)
        if str(getattr(status, "value", status)) == "VALID" \
                and slot_of(payload) >= first_slot:
            return type(status)("SYNCING")
        return status

    engine.notify_new_payload = notify


def test_an_invalid_payload_with_a_latest_valid_hash_invalidates_alike():
    """The engine's INVALID with a latestValidHash inside the optimistic
    part of the chain: both packages mark the blocks after it, and their
    descendants, invalid in fork choice, alike."""
    p = Pair()
    genesis_time = p.port.head_state.state.genesis_time
    slot_of = lambda payload: (payload.timestamp - genesis_time) // p.config.SECONDS_PER_SLOT  # noqa: E731
    for engine in (p.engine, p.jengine):
        _syncing_after(engine, slot_of, 2)
    try:
        blocks = []
        for slot in (1, 2, 3):
            block = p.produce(slot)
            signed = p.sign(block)
            assert p.port.process_block(signed) == p.jax.process_block(tc.to_jax(signed))
            blocks.append(block)
        assert [s for *_, s in p.views()[0]["nodes"][1:]] == ["valid", "syncing", "syncing"]
        block = p.produce(4)
        signed = p.sign(block)
        bad = bytes(block.body.execution_payload.block_hash)
        lvh = bytes(blocks[1].body.execution_payload.block_hash)
        for engine in (p.engine, p.jengine):
            engine.invalid_hashes.add(bad)
            engine.last_latest_valid_hash = lvh
        with pytest.raises(Exception, match="payload invalid"):
            p.port.process_block(signed)
        with pytest.raises(Exception, match="payload invalid"):
            p.jax.process_block(tc.to_jax(signed))
        view, jview = p.views()
        assert view == jview
        assert [s for *_, s in view["nodes"][1:]] == ["valid", "syncing", "invalid"]
    finally:
        p.close()
