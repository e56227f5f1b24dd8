"""The port's gossip validators (`lodestar_tpu_torch/chain/validation.py`)
against the JAX package's, exactly, on the CPU at the minimal preset with
64 validators: a table of gossip messages, valid and for each REJECT or
IGNORE branch a ladder can reach on this chain, through the attestation,
block, aggregate-and-proof, voluntary-exit, proposer- and
attester-slashing, sync-committee-message and contribution ladders of
both packages, in one order, on chains that imported the same blocks;
every `ValidationResult` equal between the packages and to the expected
action and reason. The port's chain verifies through its
`BlsLaneDispatcher` over the host tier, and each ladder's lane name
reaches it."""

import pytest
import torch
import torch_chain

from lodestar_tpu.chain import validation as jv
from lodestar_tpu.chain.bls_verifier import CpuBlsVerifier as JCpuBlsVerifier
from lodestar_tpu.chain.chain import BeaconChain as JBeaconChain
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.chain import validation as pv
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.chain.chain import BeaconChain
from lodestar_tpu_torch.chain.dispatcher import BlsLaneDispatcher
from lodestar_tpu_torch.config.beacon_config import compute_signing_root
from lodestar_tpu_torch.convert import ssz_to_jax
from lodestar_tpu_torch.params import (
    ATTESTATION_SUBNET_COUNT,
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
)
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.ssz import uint64
from lodestar_tpu_torch.types import get_types

torch.set_num_threads(1)

T = get_types(MINIMAL).altair
JT = jget_types(JMINIMAL).altair
HEAD_SLOT = 10  # the chain holds PLAN's blocks up to slot 10 (Altair)


class LaneSpy(BlsLaneDispatcher):
    """The port's lane dispatcher, recording the lane of each call."""

    def __init__(self, verifier):
        super().__init__(verifier)
        self.lanes: list = []

    def verify_signature_sets(self, sets, batchable=True, lane="aggregate"):
        self.lanes.append((lane, batchable))
        return super().verify_signature_sets(sets, batchable=batchable, lane=lane)


def _jax(value, kind):
    return ssz_to_jax(value, getattr(JT, kind))


def _tweak(value, **fields):
    out = value.copy()
    for k, v in fields.items():
        setattr(out, k, v)
    return out


def messages(chain, plan):
    """(name, ladder, clock slot, port message, JAX message, arguments,
    expected action, expected reason), in the order they are sent."""
    f, config = plan.factory, plan.config
    head = chain.head_root
    st = chain.head_state
    ctx, state = st.epoch_ctx, st.state
    out = []

    def add(name, ladder, clock, msg, kind, args, action, reason=""):
        out.append((name, ladder, clock, msg, _jax(msg, kind), args, action, reason))

    # -- attestations at slot 10 (epoch 1), committee 0 -----------------------
    slot, epoch = HEAD_SLOT, 1
    committee = [int(v) for v in ctx.get_beacon_committee(slot, 0)]
    other = [int(v) for v in ctx.get_beacon_committee(slot, 1)]
    cps = ctx.get_committee_count_per_slot(epoch)
    subnet = (cps * (slot % MINIMAL.SLOTS_PER_EPOCH)) % ATTESTATION_SUBNET_COUNT
    target = T.Checkpoint(epoch=epoch, root=chain.fork_choice.get_ancestor(head, 8))
    data = T.AttestationData(slot=slot, index=0, beacon_block_root=head,
                             source=state.current_justified_checkpoint.copy(), target=target)
    root = compute_signing_root(data.hash_tree_root(),
                                config.get_domain(DOMAIN_BEACON_ATTESTER, slot, epoch))
    own, donor = f.sign([(committee[0], root), (other[0], root)])
    n = len(committee)

    def att(bits=None, sig=own, **d):
        return T.Attestation(aggregation_bits=bits or [k == 0 for k in range(n)],
                             data=_tweak(data, **d), signature=sig)

    A = "attestation"
    add("att two bits", A, slot, att(bits=[True, True] + [False] * (n - 2)), "Attestation",
        (subnet,), "REJECT", "not exactly one bit set")
    add("att future slot", A, slot, att(slot=slot + 2), "Attestation", (subnet,),
        "IGNORE", "slot out of propagation range")
    add("att target epoch", A, slot, att(target=T.Checkpoint(epoch=0, root=target.root)),
        "Attestation", (subnet,), "REJECT", "target epoch mismatch")
    add("att unknown head", A, slot, att(beacon_block_root=b"\x77" * 32), "Attestation",
        (subnet,), "IGNORE", "unknown beacon_block_root")
    add("att target not ancestor", A, slot,
        att(target=T.Checkpoint(epoch=epoch, root=b"\x55" * 32)), "Attestation", (subnet,),
        "REJECT", "target not ancestor of head")
    add("att committee index", A, slot, att(index=cps + 3), "Attestation", (subnet,),
        "REJECT", "committee index out of range")
    add("att bits length", A, slot, att(bits=[True] + [False] * n), "Attestation", (subnet,),
        "REJECT", "wrong bits length")
    add("att wrong subnet", A, slot, att(), "Attestation", (subnet + 1,), "REJECT",
        "wrong subnet")
    add("att bad signature", A, slot, att(sig=donor), "Attestation", (subnet,), "REJECT",
        "invalid signature")
    add("att valid", A, slot, att(), "Attestation", (subnet,), "ACCEPT")
    add("att replay", A, slot, att(), "Attestation", (subnet,), "IGNORE", "already seen")
    add("att no subnet given", A, slot, att(bits=[k == 1 for k in range(n)],
                                            sig=f.sign([(committee[1], root)])[0]),
        "Attestation", (None,), "ACCEPT")

    # -- aggregates of committee 0 --------------------------------------------
    sel_root = compute_signing_root(uint64.hash_tree_root(slot),
                                    config.get_domain(DOMAIN_SELECTION_PROOF, slot))
    env_domain = config.get_domain(DOMAIN_AGGREGATE_AND_PROOF, slot)
    proofs = f.sign([(v, sel_root) for v in committee + other[:1]])
    (full,) = f.sign_aggregate([(committee, root)])

    def agg(aggregator=0, bits=None, env_key=None, proof=None, **d):
        v = (committee + other[:1])[aggregator]
        msg = T.AggregateAndProof(
            aggregator_index=v, selection_proof=proof or proofs[aggregator],
            aggregate=T.Attestation(aggregation_bits=[True] * n if bits is None else bits,
                                    data=_tweak(data, **d), signature=full))
        (sig,) = f.sign([(v if env_key is None else env_key,
                          compute_signing_root(msg.hash_tree_root(), env_domain))])
        return T.SignedAggregateAndProof(message=msg, signature=sig)

    G, K = "aggregate", "SignedAggregateAndProof"
    add("agg future slot", G, slot, agg(slot=slot + 2), K, (), "IGNORE",
        "slot out of propagation range")
    add("agg empty bits", G, slot, agg(bits=[False] * n), K, (), "REJECT",
        "empty aggregation bits")
    add("agg target epoch", G, slot, agg(target=T.Checkpoint(epoch=0, root=target.root)), K,
        (), "REJECT", "target epoch mismatch")
    add("agg unknown head", G, slot, agg(beacon_block_root=b"\x77" * 32), K, (), "IGNORE",
        "unknown beacon_block_root")
    add("agg committee index", G, slot, agg(index=cps + 3), K, (), "REJECT",
        "committee index out of range")
    add("agg bits length", G, slot, agg(bits=[True] * (n + 1)), K, (), "REJECT",
        "wrong bits length")
    add("agg not in committee", G, slot, agg(aggregator=n), K, (), "REJECT",
        "aggregator not in committee")
    add("agg bad envelope", G, slot, agg(env_key=other[0]), K, (), "REJECT",
        "invalid signatures")
    add("agg bad selection proof", G, slot, agg(proof=proofs[1]), K, (), "REJECT",
        "invalid signatures")
    add("agg valid", G, slot, agg(), K, (), "ACCEPT")
    add("agg aggregator seen", G, slot, agg(), K, (), "IGNORE", "aggregator already seen")
    add("agg covered", G, slot, agg(aggregator=1), K, (), "IGNORE", "aggregate already covered")

    # -- voluntary exits ------------------------------------------------------
    def exit_(index, exit_epoch):
        msg = T.VoluntaryExit(epoch=exit_epoch, validator_index=index)
        (sig,) = f.sign([(index % 64, compute_signing_root(
            msg.hash_tree_root(), config.get_domain(DOMAIN_VOLUNTARY_EXIT, 0, exit_epoch)))])
        return T.SignedVoluntaryExit(message=msg, signature=sig)

    X, K = "exit", "SignedVoluntaryExit"
    add("exit unknown validator", X, slot, exit_(100, 0), K, (), "REJECT", "unknown validator")
    add("exit future epoch", X, slot, exit_(3, 5), K, (), "REJECT", "exit epoch in future")
    add("exit too young", X, slot, exit_(3, 0), K, (), "REJECT", "validator too young")
    add("exit known", X, slot, exit_(7, 0), K, ("pool",), "IGNORE", "exit already known")

    # -- proposer slashings ---------------------------------------------------
    def header(proposer, hslot, body):
        h = T.BeaconBlockHeader(slot=hslot, proposer_index=proposer, parent_root=b"\x01" * 32,
                                state_root=b"\x02" * 32, body_root=body)
        (sig,) = f.sign([(proposer % 64, compute_signing_root(
            h.hash_tree_root(), config.get_domain(DOMAIN_BEACON_PROPOSER, hslot)))])
        return T.SignedBeaconBlockHeader(message=h, signature=sig)

    def pslash(a, b):
        return T.ProposerSlashing(signed_header_1=a, signed_header_2=b)

    P, K = "proposer_slashing", "ProposerSlashing"
    h1, h2 = header(5, 4, b"\x0a" * 32), header(5, 4, b"\x0b" * 32)
    add("pslash not slashable", P, slot, pslash(h1, header(5, 5, b"\x0b" * 32)), K, (),
        "REJECT", "headers not slashable")
    add("pslash identical", P, slot, pslash(h1, h1), K, (), "REJECT", "identical headers")
    add("pslash unknown proposer", P, slot,
        pslash(header(100, 4, b"\x0a" * 32), header(100, 4, b"\x0b" * 32)), K, (), "REJECT",
        "unknown proposer")
    add("pslash bad signature", P, slot,
        pslash(h1, _tweak(h2, signature=bytes(h1.signature))), K, (), "REJECT",
        "invalid signature")
    add("pslash valid", P, slot, pslash(h1, h2), K, (), "ACCEPT")
    add("pslash known", P, slot, pslash(h1, h2), K, ("pool",), "IGNORE",
        "slashing already known")

    # -- attester slashings ---------------------------------------------------
    def indexed(indices, d):
        r = compute_signing_root(d.hash_tree_root(),
                                 config.get_domain(DOMAIN_BEACON_ATTESTER, slot, epoch))
        (sig,) = f.sign_aggregate([(indices, r)])
        return T.IndexedAttestation(attesting_indices=indices, data=d, signature=sig)

    d2 = _tweak(data, beacon_block_root=b"\x33" * 32)
    S, K = "attester_slashing", "AttesterSlashing"
    add("aslash not slashable", S, slot,
        T.AttesterSlashing(attestation_1=indexed([1, 2], data), attestation_2=indexed([1, 2], data)),
        K, (), "REJECT", "not slashable")
    add("aslash disjoint", S, slot,
        T.AttesterSlashing(attestation_1=indexed([1, 2], data), attestation_2=indexed([3], d2)),
        K, (), "IGNORE", "no new slashable indices")
    bad = indexed([1, 2], d2)
    add("aslash bad signature", S, slot,
        T.AttesterSlashing(attestation_1=indexed([1, 2], data),
                           attestation_2=_tweak(bad, signature=own)), K, (), "REJECT",
        "invalid signature")
    add("aslash valid", S, slot,
        T.AttesterSlashing(attestation_1=indexed([1, 2], data), attestation_2=bad), K, (),
        "ACCEPT")

    # -- sync committee messages and contributions, subcommittee 0 ----------
    size = MINIMAL.SYNC_COMMITTEE_SUBNET_SIZE
    index_of = ctx.pubkey_to_index
    members = [index_of[bytes(pk)] for pk in state.current_sync_committee.pubkeys][:size]
    outsider = next(v for v in range(64) if v not in members)
    sync_root = compute_signing_root(head, config.get_domain(DOMAIN_SYNC_COMMITTEE, slot))

    def sync_msg(v, mslot=slot, sig=None):
        return T.SyncCommitteeMessage(slot=mslot, beacon_block_root=head, validator_index=v,
                                      signature=sig or f.sign([(v, sync_root)])[0])

    Y, K = "sync_committee", "SyncCommitteeMessage"
    add("sync old slot", Y, slot, sync_msg(members[0], mslot=5), K, (0,), "IGNORE",
        "not current slot")
    add("sync bad subnet", Y, slot, sync_msg(members[0]), K, (4,), "REJECT",
        "invalid subcommittee index")
    add("sync outsider", Y, slot, sync_msg(outsider), K, (0,), "REJECT",
        "validator not in sync subcommittee")
    add("sync bad signature", Y, slot, sync_msg(members[0], sig=donor), K, (0,), "REJECT",
        "invalid signature")
    add("sync valid", Y, slot, sync_msg(members[0]), K, (0,), "ACCEPT")
    add("sync replay", Y, slot, sync_msg(members[0]), K, (0,), "IGNORE", "already seen")

    sel = T.SyncAggregatorSelectionData(slot=slot, subcommittee_index=0)
    sel_sync = compute_signing_root(sel.hash_tree_root(), config.get_domain(
        DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, slot))
    (sub_sig,) = f.sign_aggregate([(members, sync_root)])

    def contribution(aggregator, cslot=slot, sub=0, bits=None, proof_key=None):
        c = T.SyncCommitteeContribution(
            slot=cslot, beacon_block_root=head, subcommittee_index=sub,
            aggregation_bits=[True] * size if bits is None else bits, signature=sub_sig)
        (proof,) = f.sign([(aggregator if proof_key is None else proof_key, sel_sync)])
        msg = T.ContributionAndProof(aggregator_index=aggregator, contribution=c,
                                     selection_proof=proof)
        (sig,) = f.sign([(aggregator, compute_signing_root(msg.hash_tree_root(), config
                                                           .get_domain(DOMAIN_CONTRIBUTION_AND_PROOF, slot)))])
        return T.SignedContributionAndProof(message=msg, signature=sig)

    C, K = "contribution", "SignedContributionAndProof"
    add("contrib old slot", C, slot, contribution(members[0], cslot=5), K, (), "IGNORE",
        "not current slot")
    add("contrib bad subcommittee", C, slot, contribution(members[0], sub=4), K, (), "REJECT",
        "invalid subcommittee index")
    add("contrib outsider", C, slot, contribution(outsider), K, (), "REJECT",
        "aggregator not in sync subcommittee")
    add("contrib no participants", C, slot, contribution(members[0], bits=[False] * size), K,
        (), "REJECT", "no participants")
    add("contrib bad proof", C, slot, contribution(members[0], proof_key=outsider), K, (),
        "REJECT", "invalid signature")
    add("contrib valid", C, slot, contribution(members[0]), K, (), "ACCEPT")
    add("contrib covered", C, slot, contribution(members[0]), K, (), "IGNORE",
        "participants already known")

    # -- blocks: PLAN's slot-17 block and broken copies of it ---------------
    b17 = plan.blocks[5]
    m17 = b17.message
    wrong = (int(m17.proposer_index) + 1) % 64

    def block(signature=None, **fields):
        return T.SignedBeaconBlock(message=_tweak(m17, **fields),
                                   signature=signature or bytes(b17.signature))

    B, K = "block", "SignedBeaconBlock"
    add("block future slot", B, 17, block(slot=18), K, (), "IGNORE", "future slot")
    add("block slot zero", B, 17, block(slot=0), K, (), "IGNORE", "not after finalized slot")
    add("block duplicate", B, 17, plan.blocks[4], K, (), "IGNORE", "duplicate proposal")
    add("block unknown parent", B, 17, block(parent_root=b"\x66" * 32), K, (), "IGNORE",
        "unknown parent")
    add("block parent slot", B, 17, block(slot=HEAD_SLOT, proposer_index=wrong), K, (),
        "REJECT", "parent slot not lower")
    add("block wrong proposer", B, 17, block(proposer_index=wrong), K, (), "REJECT",
        "wrong proposer")
    add("block bad signature", B, 17, block(signature=bytes(plan.blocks[4].signature)), K, (),
        "REJECT", "invalid proposer signature")
    add("block valid", B, 17, b17, K, (), "ACCEPT")
    return out


VALIDATORS = {
    "attestation": "validate_gossip_attestation",
    "aggregate": "validate_gossip_aggregate_and_proof",
    "exit": "validate_gossip_voluntary_exit",
    "proposer_slashing": "validate_gossip_proposer_slashing",
    "attester_slashing": "validate_gossip_attester_slashing",
    "sync_committee": "validate_gossip_sync_committee",
    "contribution": "validate_gossip_sync_contribution_and_proof",
    "block": "validate_gossip_block",
}
POOLS = {"exit": "add_voluntary_exit", "proposer_slashing": "add_proposer_slashing"}


def _result(res) -> tuple:
    return (res.action.value, res.reason, res.attesting_index, res.data_root, res.positions)


@pytest.fixture(scope="module")
def table():
    """Both chains after PLAN's blocks up to slot 10, then every message
    through both packages' ladders, in order; the port's results, the
    JAX package's and the lanes each port call reached."""
    plan = torch_chain.port_chain()
    jconfig, jgen = torch_chain.jax_genesis()
    spy = LaneSpy(CpuBlsVerifier())
    # the chains on phase0 types, as the node builds them; the ladders
    # take the Altair ones (the contribution ladder needs them)
    port = BeaconChain(plan.config, get_types(MINIMAL).phase0, plan.genesis.state.copy(),
                       verifier=spy)
    jax = JBeaconChain(jconfig, jget_types(JMINIMAL).phase0, jgen.state.copy(),
                       verifier=JCpuBlsVerifier())
    try:
        for signed in plan.blocks[:5]:
            for c in (port, jax):
                c.clock.set_slot(int(signed.message.slot))
            port.process_block(signed)
            jax.process_block(torch_chain.to_jax(signed, "SignedBeaconBlock"))
        rows = []
        for name, ladder, clock, msg, jmsg, args, action, reason in messages(port, plan):
            for c in (port, jax):
                c.clock.set_slot(clock)
            if args == ("pool",):
                getattr(port.op_pool, POOLS[ladder])(msg)
                getattr(jax.op_pool, POOLS[ladder])(jmsg)
                args = ()
            spy.lanes.clear()
            got = getattr(pv, VALIDATORS[ladder])(port, T, msg, *args)
            jgot = getattr(jv, VALIDATORS[ladder])(jax, JT, jmsg, *args)
            rows.append((name, ladder, (action, reason), _result(got), _result(jgot),
                         list(spy.lanes)))
        yield rows
    finally:
        port.close()
        spy.close()
        plan.factory.close()


N_MESSAGES = 59


def test_every_ladder_and_branch_is_in_the_table(table):
    assert len(table) == N_MESSAGES
    assert {ladder for _, ladder, *_ in table} == set(VALIDATORS)
    for ladder in VALIDATORS:
        actions = {want[0] for _, lad, want, *_ in table if lad == ladder}
        assert "REJECT" in actions or "IGNORE" in actions


@pytest.mark.parametrize("k", range(N_MESSAGES))
def test_message_matches_jax(table, k):
    name, ladder, want, got, jgot, _ = table[k]
    assert got == jgot, name
    assert got[:2] == want, name


LANES = {"attestation": "attestation", "aggregate": "aggregate", "exit": "aggregate",
         "proposer_slashing": "aggregate", "attester_slashing": "aggregate",
         "sync_committee": "sync_committee", "contribution": "sync_committee"}


# the exit ladder's signature check needs a validator older than
# SHARD_COMMITTEE_PERIOD (64 epochs): none is on this chain
@pytest.mark.parametrize("ladder", sorted(set(VALIDATORS) - {"exit"}))
def test_lane_names_reach_the_dispatcher(table, ladder):
    """Every signature check of a ladder reaches the port's dispatcher on
    its lane; a block's proposer signature goes unbatched."""
    calls = [lanes for _, lad, _, got, _, lanes in table if lad == ladder and lanes]
    assert calls, ladder
    for lanes in calls:
        if ladder == "block":
            assert all(batchable is False for _, batchable in lanes)
        else:
            assert lanes == [(LANES[ladder], True)]
