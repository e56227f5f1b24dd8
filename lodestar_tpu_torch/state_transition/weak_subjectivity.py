"""Weak subjectivity: how stale may a checkpoint be before it cannot be
trusted (reference: `state-transition/src/util/weakSubjectivity.ts` —
isWithinWeakSubjectivityPeriod used by checkpoint sync,
`cli/src/cmds/beacon/initBeaconState.ts`).

The port's copy of `lodestar_tpu/state_transition/weak_subjectivity.py`:
the spec's ws-period approximation from validator count and average
balance (safety decay D = 10%).
"""

from __future__ import annotations

SAFETY_DECAY = 10  # percent


def compute_weak_subjectivity_period(cached) -> int:
    """Spec compute_weak_subjectivity_period (phase0 ws-calc): epochs a
    checkpoint stays serviceable."""
    config, p, flat = cached.config, cached.preset, cached.flat
    ws_period = config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    n = len(flat.active_indices(cached.current_epoch))
    if n == 0:
        return ws_period
    total = cached.flat.total_active_balance(
        cached.current_epoch, p.EFFECTIVE_BALANCE_INCREMENT
    )
    t = total // n // 10**9  # average balance in ETH
    T = p.MAX_EFFECTIVE_BALANCE // 10**9
    delta = _churn_limit(cached)
    Delta = p.MAX_DEPOSITS * p.SLOTS_PER_EPOCH
    D = SAFETY_DECAY

    if T * (200 + 3 * D) < t * (200 + 12 * D):
        epochs_for_validator_set_churn = (
            n * (t * (200 + 12 * D) - T * (200 + 3 * D)) // (600 * delta * (2 * t + T))
        )
        epochs_for_balance_top_ups = n * (200 + 3 * D) // (600 * Delta)
        ws_period += max(epochs_for_validator_set_churn, epochs_for_balance_top_ups)
    else:
        ws_period += 3 * n * D * t // (200 * Delta * (T - t))
    return ws_period


def _churn_limit(cached) -> int:
    from ..state_transition.block import get_validator_churn_limit

    return get_validator_churn_limit(cached)


def is_within_weak_subjectivity_period(cached, ws_checkpoint_epoch: int) -> bool:
    """Is the anchor checkpoint still safe to sync from at the current
    clock epoch? (reference: checkpoint-sync gate)"""
    ws_period = compute_weak_subjectivity_period(cached)
    return cached.current_epoch <= ws_checkpoint_epoch + ws_period
