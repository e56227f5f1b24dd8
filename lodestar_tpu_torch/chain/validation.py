"""Gossip object validation (consensus p2p spec REJECT/IGNORE ladders).

Reference: `chain/validation/attestation.ts:15` (the full ladder for
`beacon_attestation_{subnet}`), `aggregateAndProof.ts`, `block.ts`.
Outcomes mirror gossipsub validation results: ACCEPT / IGNORE (don't
propagate, no penalty) / REJECT (penalize peer).

The signature check goes through the chain's pluggable verifier with
`batchable=True` semantics — on the TPU tier that means the attestation
joins the next batched device dispatch (reference: `{batchable: true}` at
attestation.ts:139).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from ..observability import spans as _spans
from ..state_transition import util as st_util
from ..state_transition.signature_sets import indexed_attestation_signature_set


class GossipAction(str, Enum):
    ACCEPT = "ACCEPT"
    IGNORE = "IGNORE"
    REJECT = "REJECT"


_LANE_SUPPORT: dict = {}


def _verify_lane(verifier, sets, lane: str) -> bool:
    """verify_signature_sets with the priority-lane hint where the facade
    accepts one (`BlsLaneDispatcher`); plain verifiers get the classic
    call. Detection mirrors `chain._verify_now`: from the signature,
    cached per underlying function — never by catching TypeError around
    the live call (which would swallow a genuine TypeError raised inside
    verification and re-run the batch). A `**kwargs` catch-all counts so
    thin forwarding wrappers still deliver the hint.

    A `BlsShedError` raised here propagates to the ladder's caller: every
    gossip ladder maps it to IGNORE (our own overload must not penalize
    the peer) and the handler's catch-all (`gossip/handlers._process`)
    already treats any escaped exception as IGNORE."""
    fn = verifier.verify_signature_sets
    key = getattr(fn, "__func__", fn)
    supports = _LANE_SUPPORT.get(key)
    if supports is None:
        import inspect

        try:
            params = inspect.signature(fn).parameters
            supports = "lane" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            supports = False
        _LANE_SUPPORT[key] = supports
    if supports:
        return verifier.verify_signature_sets(sets, lane=lane)
    return verifier.verify_signature_sets(sets)


@dataclass
class ValidationResult:
    action: GossipAction
    reason: str = ""
    attesting_index: int | None = None
    data_root: bytes | None = None
    # sync-committee messages: ALL positions the validator holds in the
    # subcommittee (committees sample with replacement — one validator can
    # own several bits)
    positions: list[int] | None = None


def validate_gossip_attestation(
    chain, types, attestation, subnet: int | None
) -> ValidationResult:
    """The beacon_attestation_{subnet} ladder (attestation.ts ordering)."""
    p = chain.preset
    data = attestation.data

    # [REJECT] exactly one aggregation bit
    bits = list(attestation.aggregation_bits)
    if sum(1 for b in bits if b) != 1:
        return ValidationResult(GossipAction.REJECT, "not exactly one bit set")

    # [IGNORE] slot within ATTESTATION_PROPAGATION_SLOT_RANGE of clock
    clock_slot = chain.clock.current_slot
    if not (
        data.slot <= clock_slot
        and clock_slot <= data.slot + p.SLOTS_PER_EPOCH
    ):
        return ValidationResult(GossipAction.IGNORE, "slot out of propagation range")

    # [REJECT] target epoch consistency
    if data.target.epoch != st_util.compute_epoch_at_slot(
        data.slot, p.SLOTS_PER_EPOCH
    ):
        return ValidationResult(GossipAction.REJECT, "target epoch mismatch")

    # [IGNORE] unknown head block (may arrive later → reprocess queue)
    head_block_root = bytes(data.beacon_block_root)
    if not chain.fork_choice.has_block(head_block_root):
        return ValidationResult(GossipAction.IGNORE, "unknown beacon_block_root")

    # [REJECT] target must be an ancestor of the head block
    target_slot = st_util.compute_start_slot_at_epoch(
        data.target.epoch, p.SLOTS_PER_EPOCH
    )
    target_ancestor = chain.fork_choice.get_ancestor(head_block_root, target_slot)
    if target_ancestor != bytes(data.target.root):
        return ValidationResult(GossipAction.REJECT, "target not ancestor of head")

    # committee lookup via the target checkpoint state (shuffling cache)
    try:
        target_state = chain.regen.get_checkpoint_state(
            data.target.epoch, bytes(data.target.root)
        )
    except Exception:
        return ValidationResult(GossipAction.IGNORE, "target state unavailable")
    ctx = target_state.epoch_ctx

    # [REJECT] committee index in range
    if data.index >= ctx.get_committee_count_per_slot(data.target.epoch):
        return ValidationResult(GossipAction.REJECT, "committee index out of range")
    committee = ctx.get_beacon_committee(data.slot, data.index)
    if len(bits) != len(committee):
        return ValidationResult(GossipAction.REJECT, "wrong bits length")

    # [REJECT] correct subnet
    if subnet is not None:
        expected = compute_subnet_for_attestation(
            ctx, data.slot, data.index, p
        )
        if subnet != expected:
            return ValidationResult(GossipAction.REJECT, "wrong subnet")

    attester_index = int(committee[bits.index(True)])

    # [IGNORE] already seen for this target epoch
    if chain.seen_attesters.is_known(data.target.epoch, attester_index):
        return ValidationResult(GossipAction.IGNORE, "already seen")

    # [REJECT] signature (batchable path on the device tier)
    sig_set = indexed_attestation_signature_set(
        target_state,
        types.IndexedAttestation(
            attesting_indices=[attester_index],
            data=data.copy(),
            signature=bytes(attestation.signature),
        ),
    )
    from .bls_verifier import BlsShedError

    try:
        with _spans.tracer.span(
            "validation/bls_verify", sets=1, slot=int(data.slot)
        ):
            sig_ok = _verify_lane(chain.bls, [sig_set], "attestation")
    except BlsShedError:
        # dispatcher admission control shed us under flood: IGNORE (no
        # peer penalty) — attestations are the first lane to shed
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")
    if not sig_ok:
        return ValidationResult(GossipAction.REJECT, "invalid signature")

    # re-check seen after the async verify (reference double-checks at
    # attestation.ts:144-155 — logical race handling)
    if chain.seen_attesters.is_known(data.target.epoch, attester_index):
        return ValidationResult(GossipAction.IGNORE, "seen during verification")
    chain.seen_attesters.add(data.target.epoch, attester_index)

    return ValidationResult(
        GossipAction.ACCEPT,
        attesting_index=attester_index,
        data_root=data.hash_tree_root(),
    )


def compute_subnet_for_attestation(ctx, slot: int, committee_index: int, p) -> int:
    """Spec compute_subnet_for_attestation (reference:
    epochContext.computeSubnetForSlot :545)."""
    from ..params import ATTESTATION_SUBNET_COUNT

    slots_since_epoch_start = slot % p.SLOTS_PER_EPOCH
    cps = ctx.get_committee_count_per_slot(
        st_util.compute_epoch_at_slot(slot, p.SLOTS_PER_EPOCH)
    )
    committees_since_epoch_start = cps * slots_since_epoch_start
    return (committees_since_epoch_start + committee_index) % ATTESTATION_SUBNET_COUNT


def validate_gossip_block(chain, types, signed_block) -> ValidationResult:
    """The beacon_block ladder (block.ts): slot/proposer/parent checks;
    full verification happens in the import pipeline."""
    block = signed_block.message
    clock_slot = chain.clock.current_slot

    # [IGNORE] future slot (beyond gossip clock disparity)
    if block.slot > clock_slot:
        return ValidationResult(GossipAction.IGNORE, "future slot")

    # [IGNORE] not newer than finalized
    fin_epoch = chain.finalized_checkpoint[0]
    fin_slot = st_util.compute_start_slot_at_epoch(
        fin_epoch, chain.preset.SLOTS_PER_EPOCH
    )
    if block.slot <= fin_slot:
        return ValidationResult(GossipAction.IGNORE, "not after finalized slot")

    # [IGNORE] already seen proposal for (slot, proposer)
    if chain.seen_block_proposers.is_known(block.slot, block.proposer_index):
        return ValidationResult(GossipAction.IGNORE, "duplicate proposal")

    # [IGNORE] parent unknown (trigger unknown-block sync)
    parent_root = bytes(block.parent_root)
    if not chain.fork_choice.has_block(parent_root):
        return ValidationResult(GossipAction.IGNORE, "unknown parent")

    # [REJECT] parent slot must be lower
    parent = chain.fork_choice.proto.get_node(parent_root)
    if parent is not None and parent.slot >= block.slot:
        return ValidationResult(GossipAction.REJECT, "parent slot not lower")

    # [REJECT] block descends from the finalized checkpoint (block.ts: the
    # current finalized block must be an ancestor of the new block)
    fin_root = chain.finalized_checkpoint[1]
    if fin_epoch > 0 and chain.fork_choice.get_ancestor(parent_root, fin_slot) != fin_root:
        return ValidationResult(
            GossipAction.REJECT, "not a descendant of finalized checkpoint"
        )

    # [REJECT] expected proposer + proposer signature, both against the
    # state at (parent_root, block.slot) — the head state may sit on a
    # different fork or epoch with a different shuffling (reference
    # block.ts verifies against getBlockSlotState)
    from ..state_transition.signature_sets import block_proposer_signature_set

    try:
        with _spans.tracer.span("validation/regen", slot=int(block.slot)):
            state = chain.regen.get_pre_state(block)
    except Exception:
        return ValidationResult(GossipAction.IGNORE, "cannot regen parent state")
    if state.epoch_ctx.get_beacon_proposer(block.slot) != int(block.proposer_index):
        return ValidationResult(GossipAction.REJECT, "wrong proposer")
    try:
        sig_set = block_proposer_signature_set(state, signed_block)
        # blocks are latency-critical (each gossip hop re-validates):
        # never sit out a batching facade's wait window
        from .chain import _verify_now

        with _spans.tracer.span("validation/bls_verify", sets=1):
            sig_ok = _verify_now(chain.bls, [sig_set])
        if not sig_ok:
            return ValidationResult(GossipAction.REJECT, "invalid proposer signature")
    except Exception:
        return ValidationResult(GossipAction.IGNORE, "cannot build signature set")

    # re-check the proposal dedup after the (possibly awaited) signature
    # verification — a concurrent duplicate must not be double-forwarded
    if chain.seen_block_proposers.is_known(block.slot, block.proposer_index):
        return ValidationResult(GossipAction.IGNORE, "duplicate proposal (post-verify)")

    return ValidationResult(GossipAction.ACCEPT)


def validate_gossip_aggregate_and_proof(chain, types, signed_agg) -> ValidationResult:
    """The beacon_aggregate_and_proof ladder (reference
    `chain/validation/aggregateAndProof.ts`): aggregator membership +
    selection proof + aggregate signature, all via the batch verifier."""
    from ..config.beacon_config import compute_signing_root
    from ..params import DOMAIN_AGGREGATE_AND_PROOF, DOMAIN_SELECTION_PROOF
    from ..ssz.hashing import sha256
    from ..state_transition.signature_sets import _pk

    p = chain.preset
    agg = signed_agg.message
    attestation = agg.aggregate
    data = attestation.data

    # [IGNORE] propagation slot range
    clock_slot = chain.clock.current_slot
    if not (data.slot <= clock_slot <= data.slot + p.SLOTS_PER_EPOCH):
        return ValidationResult(GossipAction.IGNORE, "slot out of propagation range")

    # [REJECT] has participants
    bits = list(attestation.aggregation_bits)
    if not any(bits):
        return ValidationResult(GossipAction.REJECT, "empty aggregation bits")

    # [REJECT] target epoch consistency (spec: target.epoch must match the
    # epoch of data.slot)
    if int(data.target.epoch) != st_util.compute_epoch_at_slot(
        int(data.slot), p.SLOTS_PER_EPOCH
    ):
        return ValidationResult(GossipAction.REJECT, "target epoch mismatch")

    # [IGNORE] duplicate (aggregator, target) / non-strict superset check
    target_epoch = int(data.target.epoch)
    if chain.seen_aggregators.is_known(target_epoch, int(agg.aggregator_index)):
        return ValidationResult(GossipAction.IGNORE, "aggregator already seen")
    data_root = data.hash_tree_root()
    if chain.seen_aggregated.is_known_superset(data_root, bits):
        return ValidationResult(GossipAction.IGNORE, "aggregate already covered")

    # [IGNORE] unknown head block
    head_block_root = bytes(data.beacon_block_root)
    if not chain.fork_choice.has_block(head_block_root):
        return ValidationResult(GossipAction.IGNORE, "unknown beacon_block_root")

    try:
        target_state = chain.regen.get_checkpoint_state(
            target_epoch, bytes(data.target.root)
        )
    except Exception:
        return ValidationResult(GossipAction.IGNORE, "target state unavailable")
    ctx = target_state.epoch_ctx

    # [REJECT] committee index + bits length
    if data.index >= ctx.get_committee_count_per_slot(target_epoch):
        return ValidationResult(GossipAction.REJECT, "committee index out of range")
    committee = ctx.get_beacon_committee(data.slot, data.index)
    if len(bits) != len(committee):
        return ValidationResult(GossipAction.REJECT, "wrong bits length")

    # [REJECT] aggregator is a committee member
    aggregator_index = int(agg.aggregator_index)
    if aggregator_index not in [int(i) for i in committee]:
        return ValidationResult(GossipAction.REJECT, "aggregator not in committee")

    # [REJECT] selection proof selects this validator as aggregator
    # (spec is_aggregator: hash(proof) mod max(1, len//TARGET) == 0)
    modulo = max(1, len(committee) // 16)  # TARGET_AGGREGATORS_PER_COMMITTEE=16
    if int.from_bytes(sha256(bytes(agg.selection_proof))[:8], "little") % modulo != 0:
        return ValidationResult(GossipAction.REJECT, "not selected as aggregator")

    # [REJECT] three signatures, one batch: selection proof, aggregate-and-
    # proof envelope, and the aggregate attestation itself
    from ..state_transition.signature_sets import attestation_signature_set
    from ..bls import api as bls

    sel_domain = target_state.config.get_domain(DOMAIN_SELECTION_PROOF, data.slot)
    slot_bytes = int(data.slot).to_bytes(8, "little") + b"\x00" * 24
    from ..ssz.hashing import merkleize_chunks

    slot_root = merkleize_chunks([slot_bytes], 1)
    sel_set = bls.SignatureSet(
        pubkey=_pk(target_state, aggregator_index),
        message=compute_signing_root(slot_root, sel_domain),
        signature=bytes(agg.selection_proof),
    )
    env_domain = target_state.config.get_domain(DOMAIN_AGGREGATE_AND_PROOF, data.slot)
    env_set = bls.SignatureSet(
        pubkey=_pk(target_state, aggregator_index),
        message=compute_signing_root(agg.hash_tree_root(), env_domain),
        signature=bytes(signed_agg.signature),
    )
    att_set = attestation_signature_set(target_state, types, attestation)
    from .bls_verifier import BlsShedError

    try:
        with _spans.tracer.span(
            "validation/bls_verify", sets=3, slot=int(data.slot)
        ):
            sigs_ok = _verify_lane(
                chain.bls, [sel_set, env_set, att_set], "aggregate"
            )
    except BlsShedError:
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")
    if not sigs_ok:
        return ValidationResult(GossipAction.REJECT, "invalid signatures")

    # re-check after the (batched, possibly awaited) verification so a
    # concurrent duplicate is not double-forwarded (reference
    # aggregateAndProof.ts post-verify re-check)
    if chain.seen_aggregators.is_known(target_epoch, aggregator_index):
        return ValidationResult(GossipAction.IGNORE, "aggregator seen (post-verify)")
    chain.seen_aggregators.add(target_epoch, aggregator_index)
    chain.seen_aggregated.add(target_epoch, data_root, bits)
    return ValidationResult(GossipAction.ACCEPT, data_root=data_root)


def validate_gossip_voluntary_exit(chain, types, signed_exit) -> ValidationResult:
    """Reference `chain/validation/voluntaryExit.ts`: first-seen per
    validator, then full state validity incl. signature."""
    from ..state_transition.signature_sets import voluntary_exit_signature_set

    index = int(signed_exit.message.validator_index)
    if index in chain.op_pool.voluntary_exits:
        return ValidationResult(GossipAction.IGNORE, "exit already known")
    head = chain.head_state
    if index >= len(head.flat.pubkeys):
        return ValidationResult(GossipAction.REJECT, "unknown validator")
    v = head.state.validators[index]
    cur_epoch = head.epoch_ctx.current_epoch
    from ..params.presets import FAR_FUTURE_EPOCH

    if int(v.exit_epoch) != FAR_FUTURE_EPOCH:
        return ValidationResult(GossipAction.REJECT, "already exiting")
    if not (int(v.activation_epoch) <= cur_epoch):
        return ValidationResult(GossipAction.REJECT, "not active")
    if cur_epoch < int(signed_exit.message.epoch):
        return ValidationResult(GossipAction.REJECT, "exit epoch in future")
    if cur_epoch < int(v.activation_epoch) + chain.config.chain.SHARD_COMMITTEE_PERIOD:
        return ValidationResult(GossipAction.REJECT, "validator too young")
    from .bls_verifier import BlsShedError

    try:
        if not _verify_lane(
            chain.bls, [voluntary_exit_signature_set(head, signed_exit)],
            "aggregate",
        ):
            return ValidationResult(GossipAction.REJECT, "invalid signature")
    except BlsShedError:
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")
    return ValidationResult(GossipAction.ACCEPT)


def validate_gossip_proposer_slashing(chain, types, slashing) -> ValidationResult:
    """Reference `chain/validation/proposerSlashing.ts`."""
    from ..state_transition.signature_sets import proposer_slashing_signature_sets

    index = int(slashing.signed_header_1.message.proposer_index)
    if index in chain.op_pool.proposer_slashings:
        return ValidationResult(GossipAction.IGNORE, "slashing already known")
    h1, h2 = slashing.signed_header_1.message, slashing.signed_header_2.message
    if int(h1.slot) != int(h2.slot) or int(h1.proposer_index) != int(h2.proposer_index):
        return ValidationResult(GossipAction.REJECT, "headers not slashable")
    if h1.hash_tree_root() == h2.hash_tree_root():
        return ValidationResult(GossipAction.REJECT, "identical headers")
    head = chain.head_state
    if index >= len(head.flat.pubkeys):
        return ValidationResult(GossipAction.REJECT, "unknown proposer")
    v = head.state.validators[index]
    if bool(v.slashed):
        return ValidationResult(GossipAction.IGNORE, "already slashed")
    from .bls_verifier import BlsShedError

    try:
        if not _verify_lane(
            chain.bls, proposer_slashing_signature_sets(head, slashing),
            "aggregate",
        ):
            return ValidationResult(GossipAction.REJECT, "invalid signature")
    except BlsShedError:
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")
    return ValidationResult(GossipAction.ACCEPT)


def validate_gossip_attester_slashing(chain, types, slashing) -> ValidationResult:
    """Reference `chain/validation/attesterSlashing.ts`."""
    from ..state_transition.block import is_slashable_attestation_data
    from ..state_transition.signature_sets import attester_slashing_signature_sets

    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not is_slashable_attestation_data(a1.data, a2.data):
        return ValidationResult(GossipAction.REJECT, "not slashable")
    ind1 = {int(i) for i in a1.attesting_indices}
    ind2 = {int(i) for i in a2.attesting_indices}
    head = chain.head_state
    slashable = {
        i
        for i in ind1 & ind2
        if i < len(head.flat.pubkeys) and not bool(head.state.validators[i].slashed)
    }
    if not slashable:
        return ValidationResult(GossipAction.IGNORE, "no new slashable indices")
    from .bls_verifier import BlsShedError

    try:
        if not _verify_lane(
            chain.bls, attester_slashing_signature_sets(head, slashing),
            "aggregate",
        ):
            return ValidationResult(GossipAction.REJECT, "invalid signature")
    except BlsShedError:
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")
    return ValidationResult(GossipAction.ACCEPT)


# --- sync-committee topic ladders -------------------------------------------
#
# Reference: chain/validation/syncCommittee.ts (message ladder) and
# syncCommitteeContributionAndProof.ts (contribution ladder). Both route
# their signature sets through the chain's batchable verifier like
# attestations.

def _sync_subcommittee(chain, subcommittee_index: int) -> tuple[list[int], list[bytes]]:
    """(validator indices, pubkeys) of the given subcommittee slice of the
    CURRENT sync committee, cached per sync period (the committee only
    rotates every EPOCHS_PER_SYNC_COMMITTEE_PERIOD epochs — reference
    caches an indexed committee on the epoch context,
    epochCtx.getIndexedSyncCommittee)."""
    cached = chain.head_state
    p = chain.preset
    period = cached.epoch_ctx.current_epoch // p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    cache = getattr(chain, "_sync_subcommittee_cache", None)
    if cache is None:
        cache = chain._sync_subcommittee_cache = {}
    hit = cache.get((period, subcommittee_index))
    if hit is not None:
        return hit
    state = cached.state
    size = p.SYNC_COMMITTEE_SUBNET_SIZE
    start = subcommittee_index * size
    pk_to_idx = cached.epoch_ctx.pubkey_to_index
    pubkeys = [
        bytes(pk)
        for pk in list(state.current_sync_committee.pubkeys)[start : start + size]
    ]
    members = [pk_to_idx.get(pk, -1) for pk in pubkeys]
    if len(cache) > 16:
        # evict stale periods only — the current period's entries stay hot
        for k in [k for k in cache if k[0] != period]:
            del cache[k]
    cache[(period, subcommittee_index)] = (members, pubkeys)
    return members, pubkeys


def _sync_subcommittee_members(chain, subcommittee_index: int) -> list[int]:
    return _sync_subcommittee(chain, subcommittee_index)[0]


def is_sync_committee_aggregator(selection_proof: bytes, p) -> bool:
    """spec is_sync_committee_aggregator: hash(proof)[:8] little-endian mod
    max(1, subcommittee_size // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE)."""
    from ..params import TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE
    from ..ssz.hashing import sha256

    modulo = max(
        1, p.SYNC_COMMITTEE_SUBNET_SIZE // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE
    )
    return int.from_bytes(sha256(bytes(selection_proof))[:8], "little") % modulo == 0


def validate_gossip_sync_committee(
    chain, types, msg, subnet: int
) -> ValidationResult:
    """The sync_committee_{subnet} ladder (syncCommittee.ts ordering)."""
    from ..params import SYNC_COMMITTEE_SUBNET_COUNT
    from ..state_transition.signature_sets import sync_committee_message_signature_set

    # [IGNORE] message slot is the current slot (gossip clock disparity)
    if not chain.clock.is_current_slot_given_disparity(msg.slot):
        return ValidationResult(GossipAction.IGNORE, "not current slot")

    # [REJECT] subnet id in range
    if subnet >= SYNC_COMMITTEE_SUBNET_COUNT:
        return ValidationResult(GossipAction.REJECT, "invalid subcommittee index")

    # [REJECT] the validator belongs to the declared subcommittee
    members = _sync_subcommittee_members(chain, subnet)
    if int(msg.validator_index) not in members:
        return ValidationResult(
            GossipAction.REJECT, "validator not in sync subcommittee"
        )

    # [IGNORE] first message for (slot, subnet, validator)
    if chain.seen_sync_committee.is_known(
        int(msg.slot), subnet, int(msg.validator_index)
    ):
        return ValidationResult(GossipAction.IGNORE, "already seen")

    # [REJECT] signature over beacon_block_root
    from .bls_verifier import BlsShedError

    sig_set = sync_committee_message_signature_set(chain.head_state, msg)
    try:
        if not _verify_lane(chain.bls, [sig_set], "sync_committee"):
            return ValidationResult(GossipAction.REJECT, "invalid signature")
    except BlsShedError:
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")

    # re-check the seen cache after the (possibly batched/awaited)
    # signature verification, as attestation validation does
    if chain.seen_sync_committee.is_known(
        int(msg.slot), subnet, int(msg.validator_index)
    ):
        return ValidationResult(GossipAction.IGNORE, "already seen (post-verify)")
    chain.seen_sync_committee.add(int(msg.slot), subnet, int(msg.validator_index))
    # committees sample with replacement: report EVERY position this
    # validator holds in the subcommittee — the pool must set all its
    # bits from this one (first-seen-deduped) message
    positions = [i for i, v in enumerate(members) if v == int(msg.validator_index)]
    return ValidationResult(
        GossipAction.ACCEPT,
        attesting_index=positions[0],
        positions=positions,
    )


def validate_gossip_sync_contribution_and_proof(
    chain, types, signed
) -> ValidationResult:
    """The sync_committee_contribution_and_proof ladder
    (syncCommitteeContributionAndProof.ts ordering)."""
    from ..params import SYNC_COMMITTEE_SUBNET_COUNT
    from ..state_transition.signature_sets import (
        contribution_and_proof_signature_set,
        sync_contribution_signature_set,
        sync_selection_proof_signature_set,
    )

    cap = signed.message
    contribution = cap.contribution
    slot = int(contribution.slot)
    subcommittee = int(contribution.subcommittee_index)
    aggregator = int(cap.aggregator_index)

    # [IGNORE] contribution slot is the current slot
    if not chain.clock.is_current_slot_given_disparity(slot):
        return ValidationResult(GossipAction.IGNORE, "not current slot")

    # [REJECT] subcommittee index in range
    if subcommittee >= SYNC_COMMITTEE_SUBNET_COUNT:
        return ValidationResult(GossipAction.REJECT, "invalid subcommittee index")

    # [REJECT] aggregator is a member of the declared subcommittee
    members, subcommittee_pubkeys = _sync_subcommittee(chain, subcommittee)
    if aggregator not in members:
        return ValidationResult(
            GossipAction.REJECT, "aggregator not in sync subcommittee"
        )

    # [IGNORE] participants are a non-strict subset of an already-seen one
    if chain.seen_contribution_and_proof.participants_known(contribution):
        return ValidationResult(GossipAction.IGNORE, "participants already known")

    # [IGNORE] first contribution from this aggregator for (slot, subcommittee)
    if chain.seen_contribution_and_proof.is_aggregator_known(
        slot, subcommittee, aggregator
    ):
        return ValidationResult(GossipAction.IGNORE, "aggregator already seen")

    # [REJECT] the contribution has participants
    bits = list(contribution.aggregation_bits)
    participant_pubkeys = [pk for pk, b in zip(subcommittee_pubkeys, bits) if b]
    if not participant_pubkeys:
        return ValidationResult(GossipAction.REJECT, "no participants")

    # [REJECT] selection proof selects the aggregator
    if not is_sync_committee_aggregator(cap.selection_proof, chain.preset):
        return ValidationResult(GossipAction.REJECT, "not an aggregator")

    # [REJECT] all three signatures, batched through the verifier:
    # selection proof, contribution-and-proof envelope, and the aggregate
    cached = chain.head_state
    sets = [
        sync_selection_proof_signature_set(cached, types, cap),
        contribution_and_proof_signature_set(cached, signed),
        sync_contribution_signature_set(cached, contribution, participant_pubkeys),
    ]
    from .bls_verifier import BlsShedError

    try:
        if not _verify_lane(chain.bls, sets, "sync_committee"):
            return ValidationResult(GossipAction.REJECT, "invalid signature")
    except BlsShedError:
        return ValidationResult(GossipAction.IGNORE, "verifier overloaded (shed)")

    if chain.seen_contribution_and_proof.is_aggregator_known(
        slot, subcommittee, aggregator
    ):
        return ValidationResult(GossipAction.IGNORE, "aggregator seen (post-verify)")
    chain.seen_contribution_and_proof.add(cap)
    return ValidationResult(GossipAction.ACCEPT)
