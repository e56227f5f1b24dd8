"""bellatrix (merge) SSZ container types.

Equivalent of packages/types/src/bellatrix/sszTypes.ts:
execution payloads enter the beacon block.
"""

from __future__ import annotations

from types import SimpleNamespace

from ..params.presets import Preset
from ..ssz import (
    BLSSignature,
    Bytes20,
    Bytes32,
    ByteListType,
    ByteVectorType,
    ListType,
    uint64,
    uint256,
)
from .phase0 import _container


def make_types(p: Preset, phase0: SimpleNamespace, altair: SimpleNamespace) -> SimpleNamespace:
    Root = Bytes32
    Transaction = ByteListType(p.MAX_BYTES_PER_TRANSACTION)

    _payload_prefix = [
        ("parent_hash", Bytes32),
        ("fee_recipient", Bytes20),
        ("state_root", Bytes32),
        ("receipts_root", Bytes32),
        ("logs_bloom", ByteVectorType(p.BYTES_PER_LOGS_BLOOM)),
        ("prev_randao", Bytes32),
        ("block_number", uint64),
        ("gas_limit", uint64),
        ("gas_used", uint64),
        ("timestamp", uint64),
        ("extra_data", ByteListType(p.MAX_EXTRA_DATA_BYTES)),
        ("base_fee_per_gas", uint256),
        ("block_hash", Bytes32),
    ]
    ExecutionPayload = _container(
        "ExecutionPayload",
        _payload_prefix + [("transactions", ListType(Transaction, p.MAX_TRANSACTIONS_PER_PAYLOAD))],
    )
    ExecutionPayloadHeader = _container(
        "ExecutionPayloadHeader", _payload_prefix + [("transactions_root", Root)]
    )

    BeaconBlockBody = _container(
        "BeaconBlockBody",
        altair.BeaconBlockBody.fields + [("execution_payload", ExecutionPayload.ssz_type)],
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

    BeaconState = _container(
        "BeaconState",
        altair.BeaconState.fields
        + [("latest_execution_payload_header", ExecutionPayloadHeader.ssz_type)],
    )

    # blinded flow (MEV builder API): the payload header replaces the payload
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

    PowBlock = _container(
        "PowBlock",
        [
            ("block_hash", Bytes32),
            ("parent_hash", Bytes32),
            ("total_difficulty", uint256),
        ],
    )

    merged = {k: v for k, v in vars(altair).items() if isinstance(v, type)}
    merged.update({k: v for k, v in locals().items() if isinstance(v, type)})
    return SimpleNamespace(**merged)
