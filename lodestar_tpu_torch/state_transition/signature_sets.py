"""Extract every signature set from a signed block.

The port's copy of `lodestar_tpu/state_transition/signature_sets.py`.
Reference: `state-transition/src/signatureSets/index.ts:24`
(getBlockSignatureSets) — the producer side of the batch-verification
pipeline: ~100 sets per mainnet block, fed to the device batch verifier
in one dispatch instead of per-op inline verification.

Each set carries a PRE-AGGREGATED pubkey (reference aggregates on the main
thread — `chain/bls/utils.ts:5`): aggregation is G1 addition on the C host
tier, one call per set; the pairing work stays on device.
"""

from __future__ import annotations

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_VOLUNTARY_EXIT,
)
from . import util
from .block import get_attesting_indices


def _pk(cached, index: int) -> bls.PublicKey:
    return bls.PublicKey.from_bytes(bytes(cached.flat.pubkeys[index]), validate=False)


def block_proposer_signature_set(cached, signed_block) -> bls.SignatureSet:
    block = signed_block.message
    domain = cached.config.get_domain(DOMAIN_BEACON_PROPOSER, block.slot)
    return bls.SignatureSet(
        pubkey=_pk(cached, block.proposer_index),
        message=compute_signing_root(block.hash_tree_root(), domain),
        signature=bytes(signed_block.signature),
    )


def randao_signature_set(cached, block) -> bls.SignatureSet:
    from .block import _epoch_signing_root

    epoch = util.compute_epoch_at_slot(block.slot, cached.preset.SLOTS_PER_EPOCH)
    domain = cached.config.get_domain(DOMAIN_RANDAO, block.slot)
    return bls.SignatureSet(
        pubkey=_pk(cached, block.proposer_index),
        message=_epoch_signing_root(epoch, domain),
        signature=bytes(block.body.randao_reveal),
    )


def indexed_attestation_signature_set(cached, indexed) -> bls.SignatureSet:
    domain = cached.config.get_domain(
        DOMAIN_BEACON_ATTESTER,
        util.compute_start_slot_at_epoch(
            indexed.data.target.epoch, cached.preset.SLOTS_PER_EPOCH
        ),
        indexed.data.target.epoch,
    )
    agg = bls.aggregate_pubkeys(
        [_pk(cached, i) for i in indexed.attesting_indices]
    )
    return bls.SignatureSet(
        pubkey=agg,
        message=compute_signing_root(indexed.data.hash_tree_root(), domain),
        signature=bytes(indexed.signature),
    )


def attestation_signature_set(cached, types, attestation) -> bls.SignatureSet:
    indexed = types.IndexedAttestation(
        attesting_indices=get_attesting_indices(
            cached, attestation.data, attestation.aggregation_bits
        ),
        data=attestation.data.copy(),
        signature=bytes(attestation.signature),
    )
    return indexed_attestation_signature_set(cached, indexed)


def proposer_slashing_signature_sets(cached, op) -> list[bls.SignatureSet]:
    sets = []
    for signed in (op.signed_header_1, op.signed_header_2):
        domain = cached.config.get_domain(
            DOMAIN_BEACON_PROPOSER, signed.message.slot
        )
        sets.append(
            bls.SignatureSet(
                pubkey=_pk(cached, signed.message.proposer_index),
                message=compute_signing_root(signed.message.hash_tree_root(), domain),
                signature=bytes(signed.signature),
            )
        )
    return sets


def attester_slashing_signature_sets(cached, op) -> list[bls.SignatureSet]:
    return [
        indexed_attestation_signature_set(cached, indexed)
        for indexed in (op.attestation_1, op.attestation_2)
    ]


def voluntary_exit_signature_set(cached, signed_exit) -> bls.SignatureSet:
    msg = signed_exit.message
    domain = cached.config.get_domain(
        DOMAIN_VOLUNTARY_EXIT,
        util.compute_start_slot_at_epoch(msg.epoch, cached.preset.SLOTS_PER_EPOCH),
        msg.epoch,
    )
    return bls.SignatureSet(
        pubkey=_pk(cached, msg.validator_index),
        message=compute_signing_root(msg.hash_tree_root(), domain),
        signature=bytes(signed_exit.signature),
    )


def sync_aggregate_signature_set(cached, block) -> bls.SignatureSet | None:
    """Sync-committee aggregate over the previous slot's block root
    (reference: syncCommittee signature set in signatureSets/). None when
    no bits are set — the mandatory infinity-signature rule for empty
    participation is structural and enforced inline by
    process_sync_aggregate regardless of signature verification."""
    from ..params import DOMAIN_SYNC_COMMITTEE

    state, p = cached.state, cached.preset
    aggregate = block.body.sync_aggregate
    bits = list(aggregate.sync_committee_bits)
    participants = [
        bytes(pk)
        for pk, b in zip(state.current_sync_committee.pubkeys, bits)
        if b
    ]
    if not participants:
        return None
    previous_slot = max(block.slot, 1) - 1
    domain = cached.config.get_domain(
        DOMAIN_SYNC_COMMITTEE,
        previous_slot,
        util.compute_epoch_at_slot(previous_slot, p.SLOTS_PER_EPOCH),
    )
    root = bytes(
        state.block_roots[previous_slot % p.SLOTS_PER_HISTORICAL_ROOT]
    )
    agg = bls.aggregate_pubkeys(
        [bls.PublicKey.from_bytes(pk, validate=False) for pk in participants]
    )
    return bls.SignatureSet(
        pubkey=agg,
        message=compute_signing_root(root, domain),
        signature=bytes(aggregate.sync_committee_signature),
    )


def get_block_signature_sets(
    cached, types, signed_block, include_proposer: bool = True
) -> list[bls.SignatureSet]:
    """All sets for one block (reference getBlockSignatureSets). Deposits
    are excluded: their proofs/signatures verify inline with their own
    rules (invalid deposit sigs are skipped, not failed)."""
    block = signed_block.message
    body = block.body
    sets: list[bls.SignatureSet] = []
    if include_proposer:
        sets.append(block_proposer_signature_set(cached, signed_block))
    sets.append(randao_signature_set(cached, block))
    for op in body.proposer_slashings:
        sets.extend(proposer_slashing_signature_sets(cached, op))
    for op in body.attester_slashings:
        sets.extend(attester_slashing_signature_sets(cached, op))
    for att in body.attestations:
        sets.append(attestation_signature_set(cached, types, att))
    for op in body.voluntary_exits:
        sets.append(voluntary_exit_signature_set(cached, op))
    if cached.is_altair and hasattr(body, "sync_aggregate"):
        sync_set = sync_aggregate_signature_set(cached, block)
        if sync_set is not None:
            sets.append(sync_set)
    if cached.is_capella:
        for op in body.bls_to_execution_changes:
            sets.append(bls_to_execution_change_signature_set(cached, op))
    return sets


def bls_to_execution_change_signature_set(cached, signed_change) -> bls.SignatureSet:
    from .capella import bls_to_execution_change_signing_root

    return bls.SignatureSet(
        pubkey=bls.PublicKey.from_bytes(
            bytes(signed_change.message.from_bls_pubkey), validate=False
        ),
        message=bls_to_execution_change_signing_root(
            cached.config, cached.state, signed_change.message
        ),
        signature=bytes(signed_change.signature),
    )


# --- sync-committee gossip signature sets (validation/signatureSets/) -------

def sync_committee_message_signature_set(cached, msg) -> bls.SignatureSet:
    """DOMAIN_SYNC_COMMITTEE over the message's beacon_block_root, signed
    by the referenced validator (reference
    validation/signatureSets/syncCommittee.ts:10)."""
    from ..params import DOMAIN_SYNC_COMMITTEE

    p = cached.preset
    domain = cached.config.get_domain(
        DOMAIN_SYNC_COMMITTEE,
        msg.slot,
        util.compute_epoch_at_slot(msg.slot, p.SLOTS_PER_EPOCH),
    )
    return bls.SignatureSet(
        pubkey=_pk(cached, msg.validator_index),
        message=compute_signing_root(bytes(msg.beacon_block_root), domain),
        signature=bytes(msg.signature),
    )


def sync_selection_proof_signature_set(cached, types, contribution_and_proof):
    """DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF over SyncAggregatorSelectionData
    (reference signatureSets/syncCommitteeSelectionProof.ts)."""
    from ..params import DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF

    p = cached.preset
    c = contribution_and_proof.contribution
    domain = cached.config.get_domain(
        DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        c.slot,
        util.compute_epoch_at_slot(c.slot, p.SLOTS_PER_EPOCH),
    )
    selection_data = types.SyncAggregatorSelectionData(
        slot=c.slot, subcommittee_index=c.subcommittee_index
    )
    return bls.SignatureSet(
        pubkey=_pk(cached, contribution_and_proof.aggregator_index),
        message=compute_signing_root(selection_data.hash_tree_root(), domain),
        signature=bytes(contribution_and_proof.selection_proof),
    )


def contribution_and_proof_signature_set(cached, signed) -> bls.SignatureSet:
    """DOMAIN_CONTRIBUTION_AND_PROOF over the ContributionAndProof container
    (reference signatureSets/contributionAndProof.ts:10)."""
    from ..params import DOMAIN_CONTRIBUTION_AND_PROOF

    p = cached.preset
    slot = signed.message.contribution.slot
    domain = cached.config.get_domain(
        DOMAIN_CONTRIBUTION_AND_PROOF,
        slot,
        util.compute_epoch_at_slot(slot, p.SLOTS_PER_EPOCH),
    )
    return bls.SignatureSet(
        pubkey=_pk(cached, signed.message.aggregator_index),
        message=compute_signing_root(signed.message.hash_tree_root(), domain),
        signature=bytes(signed.signature),
    )


def sync_contribution_signature_set(
    cached, contribution, participant_pubkeys: list[bytes]
) -> bls.SignatureSet:
    """DOMAIN_SYNC_COMMITTEE over the contribution's beacon_block_root with
    the aggregate of the participant pubkeys (reference
    signatureSets/syncCommitteeContribution.ts:6)."""
    from ..params import DOMAIN_SYNC_COMMITTEE

    p = cached.preset
    domain = cached.config.get_domain(
        DOMAIN_SYNC_COMMITTEE,
        contribution.slot,
        util.compute_epoch_at_slot(contribution.slot, p.SLOTS_PER_EPOCH),
    )
    agg = bls.aggregate_pubkeys(
        [bls.PublicKey.from_bytes(pk, validate=False) for pk in participant_pubkeys]
    )
    return bls.SignatureSet(
        pubkey=agg,
        message=compute_signing_root(
            bytes(contribution.beacon_block_root), domain
        ),
        signature=bytes(contribution.signature),
    )
