"""Unrealized justification/finalization: what the FFG checkpoints WOULD
become if the current epoch ended right now.

Fork choice needs this to "pull up" tips from prior epochs (reference:
`computeUnrealizedCheckpoints` imported at `forkChoice.ts:22`, used at
`forkChoice.ts:423`; spec `compute_pulled_up_tip`). Unlike
`process_justification_and_finalization` this never mutates the state —
the result is a pair of plain `(epoch, root)` tuples.
"""

from __future__ import annotations

from ..params.constants import GENESIS_EPOCH, JUSTIFICATION_BITS_LENGTH, TIMELY_TARGET_FLAG_INDEX
from . import util
from .epoch import _get_block_root, summarize_attestations


def _has_flag(participation, index):
    from .altair import has_flag

    return has_flag(participation, index)


def compute_unrealized_checkpoints(cached, types):
    """-> ((justified_epoch, justified_root), (finalized_epoch, finalized_root)).

    Runs the justification weighing (phase0 pending attestations or
    altair+ participation flags, chosen by state shape) against local
    variables only.
    """
    state, p, flat = cached.state, cached.preset, cached.flat
    current_epoch = cached.current_epoch
    cj = state.current_justified_checkpoint
    fin = state.finalized_checkpoint
    if current_epoch <= GENESIS_EPOCH + 1:
        return (
            (int(cj.epoch), bytes(cj.root)),
            (int(fin.epoch), bytes(fin.root)),
        )
    previous_epoch = cached.previous_epoch
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    total = flat.total_active_balance(current_epoch, inc)

    if hasattr(state, "previous_epoch_attestations"):
        prev_summary = summarize_attestations(
            cached, state.previous_epoch_attestations, previous_epoch
        )
        prev_target_bal = max(
            inc, int(flat.effective_balance[prev_summary.target].sum())
        )
        if state.slot <= current_epoch * p.SLOTS_PER_EPOCH:
            # state sits exactly AT the epoch start: no current-epoch
            # attestation can be included yet (min inclusion delay), and
            # the epoch's start-slot block root is not in history —
            # summarizing would assert (the spec dodges this because its
            # 2/3 condition is vacuously false)
            curr_target_bal = inc
        else:
            curr_summary = summarize_attestations(
                cached, state.current_epoch_attestations, current_epoch
            )
            curr_target_bal = max(
                inc, int(flat.effective_balance[curr_summary.target].sum())
            )
    else:

        def target_balance(participation, epoch):
            active = util.active_mask(
                flat.activation_epoch, flat.exit_epoch, epoch
            )
            mask = (
                active
                & ~flat.slashed
                & _has_flag(participation, TIMELY_TARGET_FLAG_INDEX)
            )
            return max(inc, int(flat.effective_balance[mask].sum()))

        prev_target_bal = target_balance(
            cached.previous_participation, previous_epoch
        )
        curr_target_bal = target_balance(
            cached.current_participation, current_epoch
        )

    # pure weigh: same rules as _weigh_justification_and_finalization but
    # into locals
    old_prev_j = (
        int(state.previous_justified_checkpoint.epoch),
        bytes(state.previous_justified_checkpoint.root),
    )
    old_curr_j = (int(cj.epoch), bytes(cj.root))
    justified = old_curr_j
    finalized = (int(fin.epoch), bytes(fin.root))
    bits = [False] + list(state.justification_bits)[: JUSTIFICATION_BITS_LENGTH - 1]
    if prev_target_bal * 3 >= total * 2:
        justified = (previous_epoch, bytes(_get_block_root(state, previous_epoch, p)))
        bits[1] = True
    if (
        curr_target_bal * 3 >= total * 2
        and state.slot > current_epoch * p.SLOTS_PER_EPOCH
    ):
        justified = (current_epoch, bytes(_get_block_root(state, current_epoch, p)))
        bits[0] = True
    if all(bits[1:4]) and old_prev_j[0] + 3 == current_epoch:
        finalized = old_prev_j
    if all(bits[1:3]) and old_prev_j[0] + 2 == current_epoch:
        finalized = old_prev_j
    if all(bits[0:3]) and old_curr_j[0] + 2 == current_epoch:
        finalized = old_curr_j
    if all(bits[0:2]) and old_curr_j[0] + 1 == current_epoch:
        finalized = old_curr_j
    return justified, finalized
