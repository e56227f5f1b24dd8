"""Capella state transition: withdrawals and BLS-to-execution credential
changes.

The port's copy of `lodestar_tpu/state_transition/capella.py`. Reference
surface: the capella consensus spec (the reference @ v1.1.1 predates
capella's release but ships its early container work in
`types/src/capella`); structured after `state-transition/src/block/` and
`slot/upgradeState*`: withdrawals sweep the flat balance arrays,
credential changes mutate the validator columns, historical summaries
replace historical-roots accumulation.

The sweep reads the flat columns (`withdrawal_credentials` among them)
with numpy instead of every SSZ validator's credential, and returns the
JAX module's withdrawals. Like it, a sweep that fills no payload moves
the cursor on by min(registry size, MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP);
the spec moves it by the sweep bound alone, which differs only for a
registry smaller than that bound.
"""

from __future__ import annotations

import numpy as np

from ..bls import api as bls
from ..config.beacon_config import compute_domain, compute_signing_root
from ..params import (
    BLS_WITHDRAWAL_PREFIX,
    DOMAIN_BLS_TO_EXECUTION_CHANGE,
    ETH1_ADDRESS_WITHDRAWAL_PREFIX,
)
from ..ssz.hashing import sha256
from . import util
from .block import _require, decrease_balance

U64 = np.uint64


# --- withdrawal predicates (spec capella helpers) ----------------------------

def has_eth1_withdrawal_credential(withdrawal_credentials: bytes) -> bool:
    return withdrawal_credentials[:1] == ETH1_ADDRESS_WITHDRAWAL_PREFIX


def is_fully_withdrawable_validator(
    withdrawal_credentials: bytes, withdrawable_epoch: int, balance: int, epoch: int
) -> bool:
    return (
        has_eth1_withdrawal_credential(withdrawal_credentials)
        and withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator(
    withdrawal_credentials: bytes, effective_balance: int, balance: int, preset
) -> bool:
    return (
        has_eth1_withdrawal_credential(withdrawal_credentials)
        and effective_balance == preset.MAX_EFFECTIVE_BALANCE
        and balance > preset.MAX_EFFECTIVE_BALANCE
    )


# --- withdrawals -------------------------------------------------------------

def _sweep_hits(cached, start: int, bound: int, limit: int):
    """(validator indices, fully withdrawable flags) of the first `limit`
    validators that withdraw, visiting `bound` validators from `start`
    round the registry: the spec's loop, over the flat columns."""
    flat, p = cached.flat, cached.preset
    n = len(flat)
    order = (start + np.arange(bound, dtype=np.int64)) % n
    eth1 = flat.withdrawal_credentials[order, 0] == ETH1_ADDRESS_WITHDRAWAL_PREFIX[0]
    balance = flat.balances[order]
    full = eth1 & (flat.withdrawable_epoch[order] <= U64(cached.current_epoch)) & (balance > 0)
    partial = ~full & eth1 \
        & (flat.effective_balance[order] == U64(p.MAX_EFFECTIVE_BALANCE)) \
        & (balance > U64(p.MAX_EFFECTIVE_BALANCE))
    hits = np.flatnonzero(full | partial)[:limit]
    return order[hits], full[hits]


def get_expected_withdrawals(cached, types) -> list:
    """Spec get_expected_withdrawals: bounded sweep from
    next_withdrawal_validator_index over the registry."""
    state, p, flat = cached.state, cached.preset, cached.flat
    withdrawal_index = state.next_withdrawal_index
    bound = min(len(flat), p.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
    indices, full = _sweep_hits(
        cached, state.next_withdrawal_validator_index, bound, p.MAX_WITHDRAWALS_PER_PAYLOAD
    )
    withdrawals = []
    for k, (v, is_full) in enumerate(zip(indices.tolist(), full.tolist())):
        balance = int(flat.balances[v])
        withdrawals.append(
            types.Withdrawal(
                index=withdrawal_index + k,
                validator_index=v,
                address=flat.withdrawal_credentials[v, 12:].tobytes(),
                amount=balance if is_full else balance - p.MAX_EFFECTIVE_BALANCE,
            )
        )
    return withdrawals


def process_withdrawals(cached, types, payload) -> None:
    """Spec process_withdrawals: payload withdrawals must equal the expected
    sweep; debit balances and advance the sweep cursors."""
    state, p, flat = cached.state, cached.preset, cached.flat
    expected = get_expected_withdrawals(cached, types)
    got = list(payload.withdrawals)
    _require(len(got) == len(expected), "wrong number of withdrawals")
    for g, e in zip(got, expected):
        _require(
            g.index == e.index
            and g.validator_index == e.validator_index
            and bytes(g.address) == bytes(e.address)
            and g.amount == e.amount,
            "withdrawal mismatch",
        )
    for w in expected:
        decrease_balance(cached, w.validator_index, w.amount)
    if expected:
        state.next_withdrawal_index = expected[-1].index + 1
    n = len(flat)
    if len(expected) == p.MAX_WITHDRAWALS_PER_PAYLOAD:
        # full payload: next sweep starts after the last withdrawn validator
        state.next_withdrawal_validator_index = (
            expected[-1].validator_index + 1
        ) % n
    else:
        # bounded sweep exhausted: advance cursor by the sweep bound
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index
            + min(n, p.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
        ) % n


# --- BLS → execution credential change ---------------------------------------

def bls_to_execution_change_signing_root(config, state, message) -> bytes:
    """Signed under the GENESIS fork version regardless of current fork
    (spec process_bls_to_execution_change) so changes sign once, forever."""
    domain = compute_domain(
        DOMAIN_BLS_TO_EXECUTION_CHANGE,
        config.GENESIS_FORK_VERSION,
        bytes(state.genesis_validators_root),
    )
    return compute_signing_root(message.hash_tree_root(), domain)


def process_bls_to_execution_change(cached, signed_change, verify_signatures=True):
    state = cached.state
    change = signed_change.message
    idx = change.validator_index
    _require(idx < len(state.validators), "unknown validator")
    validator = state.validators[idx]
    wc = bytes(validator.withdrawal_credentials)
    _require(wc[:1] == BLS_WITHDRAWAL_PREFIX, "not a BLS credential")
    _require(
        wc[1:] == sha256(bytes(change.from_bls_pubkey))[1:],
        "credential does not match from_bls_pubkey",
    )
    if verify_signatures:
        root = bls_to_execution_change_signing_root(cached.config, state, change)
        pk = bls.PublicKey.from_bytes(bytes(change.from_bls_pubkey))
        sig = bls.Signature.from_bytes(bytes(signed_change.signature))
        _require(bls.verify(pk, root, sig), "bad bls_to_execution_change signature")
    new_wc = (
        ETH1_ADDRESS_WITHDRAWAL_PREFIX
        + b"\x00" * 11
        + bytes(change.to_execution_address)
    )
    validator.withdrawal_credentials = new_wc
    # keep the flat column in lockstep (it is the hashing source of truth
    # and sync_to_state writes it back over the SSZ objects)
    cached.flat.withdrawal_credentials[idx] = np.frombuffer(new_wc, np.uint8)


# --- epoch: historical summaries ---------------------------------------------

def process_historical_summaries_update(cached, types) -> None:
    """Capella replaces HistoricalBatch accumulation with light
    HistoricalSummary roots (block/state roots only)."""
    p, state = cached.preset, cached.state
    next_epoch = cached.current_epoch + 1
    if next_epoch % (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH) == 0:
        from .bellatrix import _field_root

        state.historical_summaries.append(
            types.HistoricalSummary(
                block_summary_root=_field_root(state, "block_roots"),
                state_summary_root=_field_root(state, "state_roots"),
            )
        )


# --- fork upgrade ------------------------------------------------------------

def upgrade_state_to_capella(config, preset, pre, capella_types):
    """Spec upgrade_to_capella: carry bellatrix fields, extend the payload
    header with an empty withdrawals root, zero the withdrawal cursors."""
    pre = pre.copy()
    post = capella_types.BeaconState()
    skip = {
        "latest_execution_payload_header",
        "fork",
        "next_withdrawal_index",
        "next_withdrawal_validator_index",
        "historical_summaries",
    }
    for name, _ in post.fields:
        if name in skip:
            continue
        setattr(post, name, getattr(pre, name))
    old = pre.latest_execution_payload_header
    post.latest_execution_payload_header = capella_types.ExecutionPayloadHeader(
        parent_hash=bytes(old.parent_hash),
        fee_recipient=bytes(old.fee_recipient),
        state_root=bytes(old.state_root),
        receipts_root=bytes(old.receipts_root),
        logs_bloom=bytes(old.logs_bloom),
        prev_randao=bytes(old.prev_randao),
        block_number=old.block_number,
        gas_limit=old.gas_limit,
        gas_used=old.gas_used,
        timestamp=old.timestamp,
        extra_data=bytes(old.extra_data),
        base_fee_per_gas=old.base_fee_per_gas,
        block_hash=bytes(old.block_hash),
        transactions_root=bytes(old.transactions_root),
        withdrawals_root=b"\x00" * 32,
    )
    post.next_withdrawal_index = 0
    post.next_withdrawal_validator_index = 0
    post.historical_summaries = []
    post.fork = type(pre.fork)(
        previous_version=bytes(pre.fork.current_version),
        current_version=config.CAPELLA_FORK_VERSION,
        epoch=util.compute_epoch_at_slot(pre.slot, preset.SLOTS_PER_EPOCH),
    )
    return post
