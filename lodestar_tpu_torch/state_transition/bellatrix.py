"""Bellatrix (the merge) state transition: execution payloads.

The port's copy of `lodestar_tpu/state_transition/bellatrix.py`.
Reference surface: `state-transition/src/block/processExecutionPayload.ts`,
`util/execution.ts` (isMergeTransitionComplete / isExecutionEnabled),
`slot/upgradeStateToBellatrix.ts` — re-derived from the bellatrix consensus
spec. Payload *execution* validity (engine_newPayload) is not part of the
pure transition: the chain verifies it beside the signature verdict
(reference `chain/blocks/verifyBlocksExecutionPayloads.ts`); here are the
consensus-side checks and the header update, with an optional engine hook
for spec-test parity.
"""

from __future__ import annotations

from . import util
from .block import _require


def is_merge_transition_complete(state) -> bool:
    """True once the state carries a non-default execution payload header
    (spec is_merge_transition_complete)."""
    header = state.latest_execution_payload_header
    return header.hash_tree_root() != type(header)().hash_tree_root()


def has_execution_payload(body) -> bool:
    """True when the body carries a non-default execution payload."""
    payload = body.execution_payload
    return payload.hash_tree_root() != type(payload)().hash_tree_root()


def is_merge_transition_block(state, body) -> bool:
    return not is_merge_transition_complete(state) and has_execution_payload(body)


def is_execution_enabled(state, body) -> bool:
    return is_merge_transition_block(state, body) or is_merge_transition_complete(
        state
    )


def get_randao_mix(state, epoch: int, preset) -> bytes:
    return bytes(state.randao_mixes[epoch % preset.EPOCHS_PER_HISTORICAL_VECTOR])


def process_execution_payload(cached, types, body, execution_engine=None) -> None:
    """Spec process_execution_payload: parent-hash continuity, randao,
    timestamp, (optional) engine notification, header update. Capella states
    additionally carry the withdrawals root in the header."""
    state, p = cached.state, cached.preset
    payload = body.execution_payload
    if is_merge_transition_complete(state):
        _require(
            bytes(payload.parent_hash)
            == bytes(state.latest_execution_payload_header.block_hash),
            "payload parent hash mismatch",
        )
    _require(
        bytes(payload.prev_randao)
        == get_randao_mix(state, cached.current_epoch, p),
        "payload prev_randao mismatch",
    )
    _require(
        payload.timestamp == compute_timestamp_at_slot(cached.config, state),
        "payload timestamp mismatch",
    )
    if execution_engine is not None:
        status = execution_engine.notify_new_payload(payload)
        # engines return ExecutePayloadStatus (a non-empty str enum — always
        # truthy) or a plain bool; only an explicit VALID/True passes
        _require(
            status is True or getattr(status, "value", status) == "VALID",
            f"execution engine rejected payload: {status}",
        )

    header_fields = dict(
        parent_hash=bytes(payload.parent_hash),
        fee_recipient=bytes(payload.fee_recipient),
        state_root=bytes(payload.state_root),
        receipts_root=bytes(payload.receipts_root),
        logs_bloom=bytes(payload.logs_bloom),
        prev_randao=bytes(payload.prev_randao),
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=bytes(payload.extra_data),
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=bytes(payload.block_hash),
        transactions_root=_field_root(payload, "transactions"),
    )
    if cached.is_capella:
        header_fields["withdrawals_root"] = _field_root(payload, "withdrawals")
    state.latest_execution_payload_header = types.ExecutionPayloadHeader(
        **header_fields
    )


def _field_root(container, field: str) -> bytes:
    """hash_tree_root of one list/vector-typed container field (values are
    plain lists; the field's SSZ type carries the merkleization)."""
    for name, typ in container.fields:
        if name == field:
            return typ.hash_tree_root(getattr(container, field))
    raise KeyError(field)


def compute_timestamp_at_slot(config, state) -> int:
    slots_since_genesis = state.slot - 0
    return state.genesis_time + slots_since_genesis * config.SECONDS_PER_SLOT


# --- fork upgrade ------------------------------------------------------------

def upgrade_state_to_bellatrix(config, preset, pre, bellatrix_types):
    """Spec upgrade_to_bellatrix (reference: slot/upgradeStateToBellatrix):
    carry altair fields, default (pre-merge) execution payload header, bump
    fork version."""
    pre = pre.copy()
    post = bellatrix_types.BeaconState()
    for name, _ in post.fields:
        if name in ("latest_execution_payload_header", "fork"):
            continue
        setattr(post, name, getattr(pre, name))
    post.latest_execution_payload_header = bellatrix_types.ExecutionPayloadHeader()
    post.fork = type(pre.fork)(
        previous_version=bytes(pre.fork.current_version),
        current_version=config.BELLATRIX_FORK_VERSION,
        epoch=util.compute_epoch_at_slot(pre.slot, preset.SLOTS_PER_EPOCH),
    )
    return post
