"""Every signature-set producer of the port's `state_transition/
signature_sets.py` against the JAX package's, as (pubkey bytes, message,
signature) triples on the same state and the same operations (helpers in
`torch_chain.py`; operations made from a numpy seed, their signatures
random bytes: producers copy them, they do not check them). Tolerance:
bytes equal."""

import numpy as np
import pytest
import torch_chain

from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import signature_sets as jss
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import signature_sets as pss
from lodestar_tpu_torch.types import get_types

SEED = 16


def triples(sets):
    sets = sets if isinstance(sets, list) else [sets]
    return [(s.pubkey.to_bytes(), bytes(s.message), bytes(s.signature)) for s in sets]


@pytest.fixture(scope="module")
def pair():
    """(port pre-state at slot 11, JAX twin, port chain): the Altair state
    after block 10, its committees of epoch 1 and a sync committee."""
    chain = torch_chain.port_chain(plan=torch_chain.PLAN[:5])
    pre = chain.factory.advance(chain.posts[4], 11)
    jconfig = JBeaconConfig(torch_chain.jax_chain_config(),
                            bytes(chain.genesis.state.genesis_validators_root), JMINIMAL)
    return pre, torch_chain.jax_cached(jconfig, pre), chain


def operations(pre, rng):
    """Proposer and attester slashings, exits, and the block of slot 10's
    attestations, as a port Altair block body at slot 11."""
    t = get_types(MINIMAL).altair
    sig = lambda: rng.bytes(96)  # noqa: E731
    idx = [int(i) for i in rng.choice(len(pre.flat), 8, replace=False)]

    def header(slot, proposer):
        return t.SignedBeaconBlockHeader(
            message=t.BeaconBlockHeader(slot=slot, proposer_index=proposer,
                                        parent_root=rng.bytes(32), state_root=rng.bytes(32),
                                        body_root=rng.bytes(32)),
            signature=sig())

    def indexed(target_epoch):
        data = t.AttestationData(slot=target_epoch * 8 + 1, index=0,
                                 beacon_block_root=rng.bytes(32),
                                 source=t.Checkpoint(epoch=0, root=rng.bytes(32)),
                                 target=t.Checkpoint(epoch=target_epoch, root=rng.bytes(32)))
        return t.IndexedAttestation(attesting_indices=sorted(idx[:5]), data=data,
                                    signature=sig())

    return dict(
        proposer_slashings=[t.ProposerSlashing(signed_header_1=header(5, idx[0]),
                                               signed_header_2=header(5, idx[0]))],
        attester_slashings=[t.AttesterSlashing(attestation_1=indexed(0),
                                               attestation_2=indexed(1))],
        voluntary_exits=[t.SignedVoluntaryExit(
            message=t.VoluntaryExit(epoch=e, validator_index=idx[6 + e]), signature=sig())
            for e in (0, 1)],
    )


def test_block_sets_and_each_block_producer(pair):
    pre, jpre, chain = pair
    rng = np.random.default_rng(SEED)
    t, jt = get_types(MINIMAL).altair, jget_types(JMINIMAL).altair
    body = chain.blocks[4].message.body.copy()
    for name, ops in operations(pre, rng).items():
        setattr(body, name, ops)
    block = t.BeaconBlock(slot=11, proposer_index=pre.epoch_ctx.get_beacon_proposer(11),
                          parent_root=rng.bytes(32), state_root=rng.bytes(32), body=body)
    signed = t.SignedBeaconBlock(message=block, signature=rng.bytes(96))
    jsigned = torch_chain.to_jax(signed, "SignedBeaconBlock")
    ours = pss.get_block_signature_sets(pre, t, signed)
    assert len(ours) == 1 + 1 + 2 + 2 + len(body.attestations) + 2 + 1
    assert triples(ours) == triples(jss.get_block_signature_sets(jpre, jt, jsigned))
    assert triples(pss.get_block_signature_sets(pre, t, signed, include_proposer=False)) == \
        triples(jss.get_block_signature_sets(jpre, jt, jsigned, include_proposer=False))
    jbody = jsigned.message.body
    pairs = [
        (pss.block_proposer_signature_set(pre, signed),
         jss.block_proposer_signature_set(jpre, jsigned)),
        (pss.randao_signature_set(pre, block), jss.randao_signature_set(jpre, jsigned.message)),
        (pss.proposer_slashing_signature_sets(pre, body.proposer_slashings[0]),
         jss.proposer_slashing_signature_sets(jpre, jbody.proposer_slashings[0])),
        (pss.attester_slashing_signature_sets(pre, body.attester_slashings[0]),
         jss.attester_slashing_signature_sets(jpre, jbody.attester_slashings[0])),
        (pss.indexed_attestation_signature_set(pre, body.attester_slashings[0].attestation_2),
         jss.indexed_attestation_signature_set(jpre, jbody.attester_slashings[0].attestation_2)),
        (pss.attestation_signature_set(pre, t, body.attestations[1]),
         jss.attestation_signature_set(jpre, jt, jbody.attestations[1])),
        (pss.voluntary_exit_signature_set(pre, body.voluntary_exits[1]),
         jss.voluntary_exit_signature_set(jpre, jbody.voluntary_exits[1])),
        (pss.sync_aggregate_signature_set(pre, block),
         jss.sync_aggregate_signature_set(jpre, jsigned.message)),
    ]
    for k, (mine, theirs) in enumerate(pairs):
        assert triples(mine) == triples(theirs), k


def test_sync_aggregate_with_no_participant_has_no_set(pair):
    pre, jpre, chain = pair
    t = get_types(MINIMAL).altair
    block = chain.blocks[4].message.copy()
    block.body.sync_aggregate = t.SyncAggregate(
        sync_committee_bits=[False] * MINIMAL.SYNC_COMMITTEE_SIZE,
        sync_committee_signature=b"\xc0" + b"\x00" * 95)
    assert pss.sync_aggregate_signature_set(pre, block) is None
    assert jss.sync_aggregate_signature_set(jpre, torch_chain.to_jax(
        t.SignedBeaconBlock(message=block, signature=b"\x00" * 96),
        "SignedBeaconBlock").message) is None


def test_sync_committee_gossip_producers(pair):
    pre, jpre, _ = pair
    rng = np.random.default_rng(SEED + 1)
    t, jt = get_types(MINIMAL).altair, jget_types(JMINIMAL).altair
    sub = MINIMAL.SYNC_COMMITTEE_SIZE // 4
    msg = t.SyncCommitteeMessage(slot=10, beacon_block_root=rng.bytes(32), validator_index=7,
                                 signature=rng.bytes(96))
    contribution = t.SyncCommitteeContribution(
        slot=10, beacon_block_root=rng.bytes(32), subcommittee_index=2,
        aggregation_bits=[bool(b) for b in rng.integers(0, 2, sub)], signature=rng.bytes(96))
    signed = t.SignedContributionAndProof(
        message=t.ContributionAndProof(aggregator_index=11, contribution=contribution,
                                       selection_proof=rng.bytes(96)),
        signature=rng.bytes(96))
    jmsg = jt.SyncCommitteeMessage.deserialize(msg.serialize())
    jsigned = jt.SignedContributionAndProof.deserialize(signed.serialize())
    members = [bytes(pk) for pk in pre.state.current_sync_committee.pubkeys]
    participants = [pk for pk, b in zip(members[2 * sub: 3 * sub],
                                        contribution.aggregation_bits) if b]
    pairs = [
        (pss.sync_committee_message_signature_set(pre, msg),
         jss.sync_committee_message_signature_set(jpre, jmsg)),
        (pss.sync_selection_proof_signature_set(pre, t, signed.message),
         jss.sync_selection_proof_signature_set(jpre, jt, jsigned.message)),
        (pss.contribution_and_proof_signature_set(pre, signed),
         jss.contribution_and_proof_signature_set(jpre, jsigned)),
        (pss.sync_contribution_signature_set(pre, contribution, participants),
         jss.sync_contribution_signature_set(jpre, jsigned.message.contribution, participants)),
    ]
    for k, (mine, theirs) in enumerate(pairs):
        assert triples(mine) == triples(theirs), k


def test_bls_to_execution_change_is_not_ported(pair):
    """Named for the port's former refusal of Capella's BLS-to-execution
    change: its set now equals the JAX package's, signed under the genesis
    fork version whatever the state's fork."""
    pre, jpre, _ = pair
    rng = np.random.default_rng(SEED)
    t, jt = get_types(MINIMAL).capella, jget_types(JMINIMAL).capella
    for k in range(4):
        index = int(rng.integers(0, len(pre.flat)))
        change = t.SignedBLSToExecutionChange(
            message=t.BLSToExecutionChange(validator_index=index,
                                           from_bls_pubkey=bytes(pre.flat.pubkeys[index]),
                                           to_execution_address=rng.bytes(20)),
            signature=rng.bytes(96))
        jchange = jt.SignedBLSToExecutionChange.deserialize(change.serialize())
        assert triples(pss.bls_to_execution_change_signature_set(pre, change)) == triples(
            jss.bls_to_execution_change_signature_set(jpre, jchange)), k
