"""phase0 epoch processing, vectorized.

Reference surface: `state-transition/src/epoch/` (processJustificationAnd-
Finalization, getAttestationDeltas, processRegistryUpdates, processSlashings,
processEffectiveBalanceUpdates, the *Reset steps) driven by the
`EpochProcess` flat cache (`cache/epochProcess.ts:43`).

Design: one `EpochSummary` pass digests the pending attestations into
boolean participation masks (source/target/head per epoch) + per-validator
earliest-inclusion data; every subsequent step is numpy array math over
those masks — no per-validator Python loops except where the spec forces
sequential semantics (activation queue ordering, exit churn).

The port's copy of `lodestar_tpu/state_transition/epoch.py`: host code on
numpy, as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import (
    BASE_REWARDS_PER_EPOCH,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    JUSTIFICATION_BITS_LENGTH,
)
from . import util
from .block import get_validator_churn_limit

U64 = np.uint64


@dataclass
class EpochSummary:
    """Digest of one epoch's pending attestations (prev or current)."""

    source: np.ndarray          # (n,) bool — unslashed & attested (source implied)
    target: np.ndarray          # (n,) bool
    head: np.ndarray            # (n,) bool
    inclusion_delay: np.ndarray  # (n,) uint64 — earliest inclusion (0 = none)
    inclusion_proposer: np.ndarray  # (n,) int64 — proposer of that inclusion


def _get_block_root_at_slot(state, slot: int, preset) -> bytes:
    assert slot < state.slot <= slot + preset.SLOTS_PER_HISTORICAL_ROOT
    return state.block_roots[slot % preset.SLOTS_PER_HISTORICAL_ROOT]


def _get_block_root(state, epoch: int, preset) -> bytes:
    return _get_block_root_at_slot(
        state, util.compute_start_slot_at_epoch(epoch, preset.SLOTS_PER_EPOCH), preset
    )


def summarize_attestations(cached, attestations, epoch: int) -> EpochSummary:
    """Fold PendingAttestations into per-validator masks. Matching rules:
    source is implied by inclusion (process_attestation already checked the
    justified checkpoint), target = epoch boundary root, head = root at
    attestation slot."""
    n = len(cached.flat)
    state, p = cached.state, cached.preset
    source = np.zeros(n, bool)
    target = np.zeros(n, bool)
    head = np.zeros(n, bool)
    delay = np.full(n, np.iinfo(np.uint64).max, U64)
    prop = np.full(n, -1, np.int64)

    target_root = _get_block_root(state, epoch, p)
    for att in attestations:
        committee = cached.epoch_ctx.get_beacon_committee(
            att.data.slot, att.data.index
        )
        bits = np.asarray(att.aggregation_bits, bool)
        members = np.asarray(committee)[bits[: len(committee)]]
        source[members] = True
        is_target = bytes(att.data.target.root) == target_root
        if is_target:
            target[members] = True
            if bytes(att.data.beacon_block_root) == _get_block_root_at_slot(
                state, att.data.slot, p
            ):
                head[members] = True
        better = att.inclusion_delay < delay[members]
        upd = members[better]
        delay[upd] = att.inclusion_delay
        prop[upd] = att.proposer_index

    unslashed = ~cached.flat.slashed
    return EpochSummary(
        source=source & unslashed,
        target=target & unslashed,
        head=head & unslashed,
        inclusion_delay=delay,
        inclusion_proposer=prop,
    )


# --- justification & finalization ------------------------------------------

def process_justification_and_finalization(cached, types) -> None:
    state, p, flat = cached.state, cached.preset, cached.flat
    current_epoch = cached.current_epoch
    if current_epoch <= GENESIS_EPOCH + 1:
        return
    previous_epoch = cached.previous_epoch
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(current_epoch, inc)

    prev_summary = summarize_attestations(
        cached, state.previous_epoch_attestations, previous_epoch
    )
    curr_summary = summarize_attestations(
        cached, state.current_epoch_attestations, current_epoch
    )
    prev_target_bal = max(inc, int(flat.effective_balance[prev_summary.target].sum()))
    curr_target_bal = max(inc, int(flat.effective_balance[curr_summary.target].sum()))

    old_previous_justified = state.previous_justified_checkpoint.copy()
    old_current_justified = state.current_justified_checkpoint.copy()

    # shift justification bits
    bits = list(state.justification_bits)
    bits = [False] + bits[: JUSTIFICATION_BITS_LENGTH - 1]
    state.previous_justified_checkpoint = state.current_justified_checkpoint.copy()

    if prev_target_bal * 3 >= total * 2:
        state.current_justified_checkpoint = types.Checkpoint(
            epoch=previous_epoch, root=_get_block_root(state, previous_epoch, p)
        )
        bits[1] = True
    if curr_target_bal * 3 >= total * 2:
        state.current_justified_checkpoint = types.Checkpoint(
            epoch=current_epoch, root=_get_block_root(state, current_epoch, p)
        )
        bits[0] = True
    state.justification_bits = bits

    # finalization rules
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


# --- rewards & penalties ----------------------------------------------------

def _finality_delay(cached) -> int:
    return cached.previous_epoch - cached.state.finalized_checkpoint.epoch


def _is_in_inactivity_leak(cached) -> bool:
    return _finality_delay(cached) > cached.preset.MIN_EPOCHS_TO_INACTIVITY_PENALTY


def get_attestation_deltas(cached) -> tuple[np.ndarray, np.ndarray]:
    """(rewards, penalties) as int64 arrays — vectorized over validators."""
    state, p, flat = cached.state, cached.preset, cached.flat
    n = len(flat)
    previous_epoch = cached.previous_epoch
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(cached.current_epoch, inc)
    sqrt_total = util.integer_squareroot(total)

    eff = flat.effective_balance.astype(np.int64)
    base_reward = (
        eff * p.BASE_REWARD_FACTOR // sqrt_total // BASE_REWARDS_PER_EPOCH
    )
    proposer_reward = base_reward // p.PROPOSER_REWARD_QUOTIENT

    active_prev = util.active_mask(
        flat.activation_epoch, flat.exit_epoch, previous_epoch
    )
    eligible = active_prev | (
        flat.slashed & (U64(previous_epoch + 1) < flat.withdrawable_epoch)
    )

    s = summarize_attestations(
        cached, state.previous_epoch_attestations, previous_epoch
    )
    rewards = np.zeros(n, np.int64)
    penalties = np.zeros(n, np.int64)
    in_leak = _is_in_inactivity_leak(cached)

    for mask in (s.source, s.target, s.head):
        attesting_bal = max(inc, int(flat.effective_balance[mask].sum()))
        att = eligible & mask
        non = eligible & ~mask
        if in_leak:
            rewards[att] += base_reward[att]
        else:
            rewards[att] += (
                base_reward[att] * (attesting_bal // inc) // (total // inc)
            )
        penalties[non] += base_reward[non]

    # inclusion delay: attester + proposer micro-rewards
    src = s.source & (s.inclusion_proposer >= 0)
    idxs = np.nonzero(src)[0]
    for i in idxs:
        rewards[s.inclusion_proposer[i]] += proposer_reward[i]
        max_attester = base_reward[i] - proposer_reward[i]
        rewards[i] += max_attester // int(s.inclusion_delay[i])

    # inactivity leak
    if in_leak:
        pen = BASE_REWARDS_PER_EPOCH * base_reward - proposer_reward
        penalties[eligible] += pen[eligible]
        not_target = eligible & ~s.target
        penalties[not_target] += (
            eff[not_target] * _finality_delay(cached) // p.INACTIVITY_PENALTY_QUOTIENT
        )

    return rewards, penalties


def process_rewards_and_penalties(cached) -> None:
    if cached.current_epoch == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(cached)
    flat = cached.flat
    bal = flat.balances.astype(np.int64)
    bal = bal + rewards
    bal = np.maximum(0, bal - penalties)
    flat.balances = bal.astype(U64)


# --- registry updates -------------------------------------------------------

def process_registry_updates(cached) -> None:
    from .block import initiate_validator_exit

    state, p, flat, config = cached.state, cached.preset, cached.flat, cached.config
    current_epoch = cached.current_epoch

    # eligibility for the activation queue
    eligible_queue = (
        (flat.activation_eligibility_epoch == U64(FAR_FUTURE_EPOCH))
        & (flat.effective_balance == U64(p.MAX_EFFECTIVE_BALANCE))
    )
    flat.activation_eligibility_epoch[eligible_queue] = current_epoch + 1

    # ejections (sequential: each exit consumes churn)
    active_now = util.active_mask(flat.activation_epoch, flat.exit_epoch, current_epoch)
    ejectable = np.nonzero(
        active_now & (flat.effective_balance <= U64(config.EJECTION_BALANCE))
    )[0]
    for idx in ejectable:
        initiate_validator_exit(cached, int(idx))

    # dequeue activations up to churn, ordered by (eligibility_epoch, index)
    finalized = state.finalized_checkpoint.epoch
    can_activate = (
        (flat.activation_eligibility_epoch <= U64(finalized))
        & (flat.activation_epoch == U64(FAR_FUTURE_EPOCH))
    )
    queue = sorted(
        np.nonzero(can_activate)[0],
        key=lambda i: (int(flat.activation_eligibility_epoch[i]), int(i)),
    )
    churn = get_validator_churn_limit(cached)
    activation_epoch = util.compute_activation_exit_epoch(
        current_epoch, p.MAX_SEED_LOOKAHEAD
    )
    for idx in queue[:churn]:
        flat.activation_epoch[idx] = activation_epoch


# --- slashings --------------------------------------------------------------

def process_slashings(cached) -> None:
    state, p, flat = cached.state, cached.preset, cached.flat
    epoch = cached.current_epoch
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(epoch, inc)
    total_slashings = sum(int(x) for x in state.slashings)
    adjusted = min(total_slashings * p.PROPORTIONAL_SLASHING_MULTIPLIER, total)

    target_epoch = epoch + p.EPOCHS_PER_SLASHINGS_VECTOR // 2
    hit = flat.slashed & (flat.withdrawable_epoch == U64(target_epoch))
    idxs = np.nonzero(hit)[0]
    for i in idxs:
        eff = int(flat.effective_balance[i])
        penalty = eff // inc * adjusted // total * inc
        flat.balances[i] = max(0, int(flat.balances[i]) - penalty)


# --- the reset / bookkeeping tail ------------------------------------------

def process_eth1_data_reset(cached) -> None:
    p = cached.preset
    next_epoch = cached.current_epoch + 1
    if next_epoch % p.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        cached.state.eth1_data_votes = []


def process_effective_balance_updates(cached) -> None:
    p, flat = cached.preset, cached.flat
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    hysteresis_inc = inc // p.HYSTERESIS_QUOTIENT
    down = hysteresis_inc * p.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_inc * p.HYSTERESIS_UPWARD_MULTIPLIER
    bal = flat.balances.astype(np.int64)
    eff = flat.effective_balance.astype(np.int64)
    update = (bal + down < eff) | (eff + up < bal)
    new_eff = np.minimum(bal - bal % inc, p.MAX_EFFECTIVE_BALANCE)
    flat.effective_balance = np.where(update, new_eff, eff).astype(U64)


def process_slashings_reset(cached) -> None:
    p = cached.preset
    next_epoch = cached.current_epoch + 1
    cached.state.slashings[next_epoch % p.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(cached) -> None:
    p, state = cached.preset, cached.state
    current_epoch = cached.current_epoch
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % p.EPOCHS_PER_HISTORICAL_VECTOR] = (
        util.get_randao_mix(state, current_epoch, p.EPOCHS_PER_HISTORICAL_VECTOR)
    )


def process_historical_roots_update(cached, types) -> None:
    p, state = cached.preset, cached.state
    next_epoch = cached.current_epoch + 1
    if next_epoch % (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH) == 0:
        batch = types.HistoricalBatch(
            block_roots=list(state.block_roots),
            state_roots=list(state.state_roots),
        )
        state.historical_roots.append(batch.hash_tree_root())


def process_participation_record_updates(cached) -> None:
    state = cached.state
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


# --- orchestration ----------------------------------------------------------

def process_epoch(cached, types) -> None:
    """Spec order (phase0). Mutates flat arrays; `sync_to_state` is called
    by the slot driver before any hash_tree_root."""
    process_justification_and_finalization(cached, types)
    process_rewards_and_penalties(cached)
    process_registry_updates(cached)
    process_slashings(cached)
    process_eth1_data_reset(cached)
    process_effective_balance_updates(cached)
    process_slashings_reset(cached)
    process_randao_mixes_reset(cached)
    process_historical_roots_update(cached, types)
    process_participation_record_updates(cached)
