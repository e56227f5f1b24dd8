"""capella SSZ container types.

Equivalent of packages/types/src/capella/sszTypes.ts:
withdrawals + BLS-to-execution credential changes + historical summaries.
"""

from __future__ import annotations

from types import SimpleNamespace

from ..params.presets import Preset
from ..ssz import (
    BLSPubkey,
    BLSSignature,
    Bytes20,
    Bytes32,
    ListType,
    uint64,
)
from .phase0 import _container


def make_types(
    p: Preset, phase0: SimpleNamespace, altair: SimpleNamespace, bellatrix: SimpleNamespace
) -> SimpleNamespace:
    Root = Bytes32

    Withdrawal = _container(
        "Withdrawal",
        [
            ("index", uint64),
            ("validator_index", uint64),
            ("address", Bytes20),
            ("amount", uint64),
        ],
    )
    BLSToExecutionChange = _container(
        "BLSToExecutionChange",
        [
            ("validator_index", uint64),
            ("from_bls_pubkey", BLSPubkey),
            ("to_execution_address", Bytes20),
        ],
    )
    SignedBLSToExecutionChange = _container(
        "SignedBLSToExecutionChange",
        [("message", BLSToExecutionChange.ssz_type), ("signature", BLSSignature)],
    )
    HistoricalSummary = _container(
        "HistoricalSummary",
        [("block_summary_root", Root), ("state_summary_root", Root)],
    )

    # ExecutionPayload gains `withdrawals`
    ExecutionPayload = _container(
        "ExecutionPayload",
        bellatrix.ExecutionPayload.fields
        + [("withdrawals", ListType(Withdrawal.ssz_type, p.MAX_WITHDRAWALS_PER_PAYLOAD))],
    )
    ExecutionPayloadHeader = _container(
        "ExecutionPayloadHeader",
        bellatrix.ExecutionPayloadHeader.fields + [("withdrawals_root", Root)],
    )

    body_fields = [
        (name, ExecutionPayload.ssz_type if name == "execution_payload" else typ)
        for name, typ in bellatrix.BeaconBlockBody.fields
    ]
    BeaconBlockBody = _container(
        "BeaconBlockBody",
        body_fields
        + [
            (
                "bls_to_execution_changes",
                ListType(SignedBLSToExecutionChange.ssz_type, p.MAX_BLS_TO_EXECUTION_CHANGES),
            )
        ],
    )
    BeaconBlock = _container(
        "BeaconBlock",
        [
            ("slot", uint64),
            ("proposer_index", uint64),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBody.ssz_type),
        ],
    )
    SignedBeaconBlock = _container(
        "SignedBeaconBlock",
        [("message", BeaconBlock.ssz_type), ("signature", BLSSignature)],
    )

    # blinded body: the header sits exactly in the payload's field position
    BlindedBeaconBlockBody = _container(
        "BlindedBeaconBlockBody",
        [
            ("execution_payload_header", ExecutionPayloadHeader.ssz_type)
            if n == "execution_payload"
            else (n, t)
            for n, t in BeaconBlockBody.fields
        ],
    )
    BlindedBeaconBlock = _container(
        "BlindedBeaconBlock",
        [
            ("slot", uint64),
            ("proposer_index", uint64),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BlindedBeaconBlockBody.ssz_type),
        ],
    )
    SignedBlindedBeaconBlock = _container(
        "SignedBlindedBeaconBlock",
        [("message", BlindedBeaconBlock.ssz_type), ("signature", BLSSignature)],
    )

    state_fields = [
        (
            name,
            ExecutionPayloadHeader.ssz_type
            if name == "latest_execution_payload_header"
            else typ,
        )
        for name, typ in bellatrix.BeaconState.fields
    ]
    BeaconState = _container(
        "BeaconState",
        state_fields
        + [
            ("next_withdrawal_index", uint64),
            ("next_withdrawal_validator_index", uint64),
            (
                "historical_summaries",
                ListType(HistoricalSummary.ssz_type, p.HISTORICAL_ROOTS_LIMIT),
            ),
        ],
    )

    merged = {k: v for k, v in vars(bellatrix).items() if isinstance(v, type)}
    merged.update({k: v for k, v in locals().items() if isinstance(v, type)})
    return SimpleNamespace(**merged)
