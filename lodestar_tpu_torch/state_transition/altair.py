"""Altair state transition: participation flags, sync committees,
inactivity scores.

The port's copy of `lodestar_tpu/state_transition/altair.py`; the sync
aggregate's inline check and the sync committees' aggregate keys go to
the C host tier. Reference surface:
`state-transition/src/block/processAttestationsAltair`,
`processSyncCommittee`, `epoch/` altair branches, `slot/upgradeStateToAltair`
— re-derived from the altair consensus spec. Participation flags and
inactivity scores live in flat numpy uint8/uint64 arrays on the cache
(`CachedBeaconState.participation`), synced into the SSZ state before any
hash, in the same style as `FlatValidators`.
"""

from __future__ import annotations

import numpy as np

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import (
    DOMAIN_SYNC_COMMITTEE,
    GENESIS_EPOCH,
    JUSTIFICATION_BITS_LENGTH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)
from . import util
from .block import (
    _require,
    decrease_balance,
    get_attesting_indices,
    increase_balance,
)
from .epoch import _get_block_root, _get_block_root_at_slot

U64 = np.uint64


# --- participation flag helpers ---------------------------------------------

def has_flag(flags: np.ndarray | int, index: int):
    return (flags >> index) & 1 != 0 if isinstance(flags, int) else (
        (flags >> np.uint8(index)) & np.uint8(1)
    ).astype(bool)


def add_flag(flags, index: int):
    return flags | (1 << index)


# --- attestation participation (spec get_attestation_participation_flags) ---

def get_attestation_participation_flag_indices(
    cached, data, inclusion_delay: int
) -> list[int]:
    state, p = cached.state, cached.preset
    if data.target.epoch == cached.current_epoch:
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    is_matching_source = data.source == justified
    _require(is_matching_source, "wrong source checkpoint")
    is_matching_target = bytes(data.target.root) == _get_block_root(
        state, data.target.epoch, p
    )
    is_matching_head = is_matching_target and bytes(
        data.beacon_block_root
    ) == _get_block_root_at_slot(state, data.slot, p)

    flags = []
    if is_matching_source and inclusion_delay <= util.integer_squareroot(
        p.SLOTS_PER_EPOCH
    ):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= p.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == p.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def get_base_reward_per_increment(cached) -> int:
    p = cached.preset
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = cached.flat.total_active_balance(cached.current_epoch, inc)
    return inc * p.BASE_REWARD_FACTOR // util.integer_squareroot(total)


def process_attestation_altair(cached, types, attestation, verify_signatures: bool = True) -> None:
    """Altair processAttestation: validity checks as phase0, then set
    participation flags + pay the proposer (no PendingAttestation lists)."""
    state, p, flat = cached.state, cached.preset, cached.flat
    data = attestation.data
    _require(
        data.target.epoch in (cached.previous_epoch, cached.current_epoch),
        "target epoch out of range",
    )
    _require(
        data.target.epoch == util.compute_epoch_at_slot(data.slot, p.SLOTS_PER_EPOCH),
        "target epoch != slot epoch",
    )
    _require(
        data.slot + p.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot,
        "attestation too new",
    )
    _require(state.slot <= data.slot + p.SLOTS_PER_EPOCH, "attestation too old")
    _require(
        data.index < cached.epoch_ctx.get_committee_count_per_slot(data.target.epoch),
        "committee index out of range",
    )
    inclusion_delay = state.slot - data.slot
    flag_indices = get_attestation_participation_flag_indices(
        cached, data, inclusion_delay
    )
    indices = get_attesting_indices(cached, data, attestation.aggregation_bits)
    if verify_signatures:
        from .block import is_valid_indexed_attestation

        indexed = types.IndexedAttestation(
            attesting_indices=indices,
            data=data.copy(),
            signature=bytes(attestation.signature),
        )
        _require(
            is_valid_indexed_attestation(cached, indexed, True),
            "bad attestation signature",
        )

    epoch_participation = (
        cached.current_participation
        if data.target.epoch == cached.current_epoch
        else cached.previous_participation
    )
    base_per_inc = get_base_reward_per_increment(cached)
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    proposer_reward_numerator = 0
    for idx in indices:
        base_reward = int(flat.effective_balance[idx]) // inc * base_per_inc
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in flag_indices and not (
                int(epoch_participation[idx]) >> flag_index
            ) & 1:
                epoch_participation[idx] = add_flag(
                    int(epoch_participation[idx]), flag_index
                )
                proposer_reward_numerator += base_reward * weight
    proposer_reward = proposer_reward_numerator // (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    )
    increase_balance(
        cached, cached.epoch_ctx.get_beacon_proposer(state.slot), proposer_reward
    )


# --- sync aggregate ----------------------------------------------------------

def process_sync_aggregate(cached, aggregate, verify_signatures: bool = True):
    """Spec process_sync_aggregate: verify the committee signature over the
    previous slot's block root, pay participants, charge absentees."""
    state, p, flat = cached.state, cached.preset, cached.flat
    committee_pubkeys = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    bits = list(aggregate.sync_committee_bits)
    participant_pubkeys = [pk for pk, b in zip(committee_pubkeys, bits) if b]

    # structural rule, enforced regardless of signature verification (the
    # batched extractor emits no set for empty participation): zero bits
    # must carry the infinity signature
    if not participant_pubkeys:
        _require(
            bytes(aggregate.sync_committee_signature) == b"\xc0" + b"\x00" * 95,
            "non-infinity signature with no participants",
        )
    elif verify_signatures:
        previous_slot = max(state.slot, 1) - 1
        domain = cached.config.get_domain(
            DOMAIN_SYNC_COMMITTEE,
            previous_slot,
            util.compute_epoch_at_slot(previous_slot, p.SLOTS_PER_EPOCH),
        )
        root = compute_signing_root(
            _get_block_root_at_slot(state, previous_slot, p), domain
        )
        pks = [bls.PublicKey.from_bytes(pk, validate=False) for pk in participant_pubkeys]
        sig = bls.Signature.from_bytes(
            bytes(aggregate.sync_committee_signature), validate=False
        )
        _require(
            bls.fast_aggregate_verify(pks, root, sig), "bad sync aggregate sig"
        )

    # rewards (spec formulae)
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total_active_increments = (
        cached.flat.total_active_balance(cached.current_epoch, inc) // inc
    )
    base_per_inc = get_base_reward_per_increment(cached)
    total_base_rewards = base_per_inc * total_active_increments
    max_participant_rewards = (
        total_base_rewards * SYNC_REWARD_WEIGHT // WEIGHT_DENOMINATOR // p.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // p.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )
    proposer_index = cached.epoch_ctx.get_beacon_proposer(state.slot)
    pk_to_idx = cached.epoch_ctx.pubkey_to_index
    for pk, participated in zip(committee_pubkeys, bits):
        idx = pk_to_idx[pk]
        if participated:
            increase_balance(cached, idx, participant_reward)
            increase_balance(cached, proposer_index, proposer_reward)
        else:
            decrease_balance(cached, idx, participant_reward)


# --- sync committee computation ---------------------------------------------

def get_next_sync_committee(cached, types):
    """Spec get_next_sync_committee: effective-balance-weighted sampling of
    SYNC_COMMITTEE_SIZE members from the next epoch's active set."""
    from ..params import DOMAIN_SYNC_COMMITTEE as _D  # seed domain constant
    from ..ssz.hashing import sha256

    state, p, flat = cached.state, cached.preset, cached.flat
    epoch = cached.current_epoch + 1
    active = flat.active_indices(epoch)
    seed = util.get_seed(state, epoch, _D, p)
    total = len(active)
    indices = []
    i = 0
    while len(indices) < p.SYNC_COMMITTEE_SIZE:
        shuffled_i = util.compute_shuffled_index(
            i % total, total, seed, p.SHUFFLE_ROUND_COUNT
        )
        candidate = int(active[shuffled_i])
        rand = sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        if int(flat.effective_balance[candidate]) * 255 >= p.MAX_EFFECTIVE_BALANCE * rand:
            indices.append(candidate)
        i += 1
    pubkeys = [bytes(flat.pubkeys[idx]) for idx in indices]
    agg = bls.aggregate_pubkeys(
        [bls.PublicKey.from_bytes(pk, validate=False) for pk in pubkeys]
    )
    return types.SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=agg.to_bytes())


# --- epoch processing (altair variants) -------------------------------------

def process_inactivity_updates(cached) -> None:
    state, p, flat, config = cached.state, cached.preset, cached.flat, cached.config
    if cached.current_epoch == GENESIS_EPOCH:
        return
    prev = cached.previous_epoch
    scores = cached.inactivity_scores
    active_prev = util.active_mask(flat.activation_epoch, flat.exit_epoch, prev)
    eligible = active_prev | (
        flat.slashed & (U64(prev + 1) < flat.withdrawable_epoch)
    )
    target = has_flag(cached.previous_participation, TIMELY_TARGET_FLAG_INDEX) & (
        ~flat.slashed
    )
    # increase by bias for non-participants, else decrement by 1
    scores[eligible & target] -= np.minimum(
        U64(1), scores[eligible & target]
    )
    scores[eligible & ~target] += U64(config.INACTIVITY_SCORE_BIAS)
    # recovery when not in leak
    leak = (prev - state.finalized_checkpoint.epoch) > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    if not leak:
        dec = np.minimum(U64(config.INACTIVITY_SCORE_RECOVERY_RATE), scores)
        scores[eligible] -= dec[eligible]


def process_justification_and_finalization_altair(cached, types) -> None:

    state, p, flat = cached.state, cached.preset, cached.flat
    current_epoch = cached.current_epoch
    if current_epoch <= GENESIS_EPOCH + 1:
        return
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(current_epoch, inc)

    def target_balance(participation, epoch):
        active = util.active_mask(flat.activation_epoch, flat.exit_epoch, epoch)
        mask = active & ~flat.slashed & has_flag(
            participation, TIMELY_TARGET_FLAG_INDEX
        )
        return max(inc, int(flat.effective_balance[mask].sum()))

    prev_target = target_balance(cached.previous_participation, cached.previous_epoch)
    curr_target = target_balance(cached.current_participation, current_epoch)
    _weigh_justification_and_finalization(
        cached, types, total, prev_target, curr_target
    )


def _weigh_justification_and_finalization(
    cached, types, total, prev_target_bal, curr_target_bal
) -> None:
    state, p = cached.state, cached.preset
    current_epoch = cached.current_epoch
    previous_epoch = cached.previous_epoch
    old_previous_justified = state.previous_justified_checkpoint.copy()
    old_current_justified = state.current_justified_checkpoint.copy()
    checkpoint_cls = type(state.current_justified_checkpoint)
    bits = list(state.justification_bits)
    bits = [False] + bits[: JUSTIFICATION_BITS_LENGTH - 1]
    state.previous_justified_checkpoint = state.current_justified_checkpoint.copy()
    if prev_target_bal * 3 >= total * 2:
        state.current_justified_checkpoint = checkpoint_cls(
            epoch=previous_epoch, root=_get_block_root(state, previous_epoch, p)
        )
        bits[1] = True
    if curr_target_bal * 3 >= total * 2:
        state.current_justified_checkpoint = checkpoint_cls(
            epoch=current_epoch, root=_get_block_root(state, current_epoch, p)
        )
        bits[0] = True
    state.justification_bits = bits
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


def process_rewards_and_penalties_altair(cached) -> None:
    state, p, flat, config = cached.state, cached.preset, cached.flat, cached.config
    if cached.current_epoch == GENESIS_EPOCH:
        return
    prev = cached.previous_epoch
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(cached.current_epoch, inc)
    base_per_inc = get_base_reward_per_increment(cached)
    eff = flat.effective_balance.astype(np.int64)
    base_reward = eff // inc * base_per_inc

    active_prev = util.active_mask(flat.activation_epoch, flat.exit_epoch, prev)
    eligible = active_prev | (
        flat.slashed & (U64(prev + 1) < flat.withdrawable_epoch)
    )
    leak = (prev - state.finalized_checkpoint.epoch) > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    rewards = np.zeros(len(flat), np.int64)
    penalties = np.zeros(len(flat), np.int64)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        unslashed = (
            has_flag(cached.previous_participation, flag_index) & ~flat.slashed
        )
        unslashed_bal = max(inc, int(flat.effective_balance[unslashed].sum()))
        att = eligible & unslashed
        non = eligible & ~unslashed
        if not leak:
            reward_numerator = (
                base_reward[att] * weight * (unslashed_bal // inc)
            )
            rewards[att] += reward_numerator // (
                (total // inc) * WEIGHT_DENOMINATOR
            )
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties[non] += base_reward[non] * weight // WEIGHT_DENOMINATOR

    # inactivity penalties (altair: score-scaled)
    target_flag = has_flag(cached.previous_participation, TIMELY_TARGET_FLAG_INDEX) & (
        ~flat.slashed
    )
    not_target = eligible & ~target_flag
    scores = cached.inactivity_scores.astype(np.int64)
    inactivity_quotient = (
        p.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
        if cached.is_execution
        else p.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
    )
    penalties[not_target] += (
        eff[not_target] * scores[not_target]
        // (config.INACTIVITY_SCORE_BIAS * inactivity_quotient)
    )

    bal = flat.balances.astype(np.int64) + rewards
    flat.balances = np.maximum(0, bal - penalties).astype(U64)


def process_participation_flag_updates(cached) -> None:
    cached.previous_participation = cached.current_participation
    cached.current_participation = np.zeros(len(cached.flat), np.uint8)


def process_sync_committee_updates(cached, types) -> None:
    p = cached.preset
    next_epoch = cached.current_epoch + 1
    if next_epoch % p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state = cached.state
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(cached, types)


def process_slashings_altair(cached) -> None:
    state, p, flat = cached.state, cached.preset, cached.flat
    epoch = cached.current_epoch
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(epoch, inc)
    total_slashings = sum(int(x) for x in state.slashings)
    multiplier = (
        p.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX
        if cached.is_execution
        else p.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
    )
    adjusted = min(total_slashings * multiplier, total)
    target_epoch = epoch + p.EPOCHS_PER_SLASHINGS_VECTOR // 2
    hit = flat.slashed & (flat.withdrawable_epoch == U64(target_epoch))
    for i in np.nonzero(hit)[0]:
        eff = int(flat.effective_balance[i])
        penalty = eff // inc * adjusted // total * inc
        flat.balances[i] = max(0, int(flat.balances[i]) - penalty)


def process_epoch_altair(cached, types) -> None:
    from .epoch import (
        process_effective_balance_updates,
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_registry_updates,
        process_slashings_reset,
    )

    process_justification_and_finalization_altair(cached, types)
    process_inactivity_updates(cached)
    process_rewards_and_penalties_altair(cached)
    process_registry_updates(cached)
    process_slashings_altair(cached)
    process_eth1_data_reset(cached)
    process_effective_balance_updates(cached)
    process_slashings_reset(cached)
    process_randao_mixes_reset(cached)
    if cached.is_capella:
        from .capella import process_historical_summaries_update

        process_historical_summaries_update(cached, types)
    else:
        process_historical_roots_update(cached, types)
    process_participation_flag_updates(cached)
    process_sync_committee_updates(cached, types)


# --- fork upgrade ------------------------------------------------------------

def upgrade_state_to_altair(config, preset, pre, altair_types):
    """Spec upgrade_to_altair (reference: slot/upgradeStateToAltair):
    carry fields over, empty participation, zero inactivity scores, set
    the fork version, and compute both sync committees (identical at the
    fork — both are get_next_sync_committee of the post state)."""
    from .cache import CachedBeaconState

    n = len(pre.validators)
    pre = pre.copy()
    post = altair_types.BeaconState()
    for name, _ in post.fields:
        if name in (
            "previous_epoch_participation",
            "current_epoch_participation",
            "inactivity_scores",
            "current_sync_committee",
            "next_sync_committee",
            "fork",
        ):
            continue
        setattr(post, name, getattr(pre, name))
    post.previous_epoch_participation = [0] * n
    post.current_epoch_participation = [0] * n
    post.inactivity_scores = [0] * n
    post.fork = type(pre.fork)(
        previous_version=bytes(pre.fork.current_version),
        current_version=config.ALTAIR_FORK_VERSION,
        epoch=util.compute_epoch_at_slot(pre.slot, preset.SLOTS_PER_EPOCH),
    )
    cached = CachedBeaconState(config, post, preset)
    committee = get_next_sync_committee(cached, altair_types)
    post.current_sync_committee = committee
    post.next_sync_committee = committee.copy()
    return post
