"""altair SSZ container types.

Equivalent of packages/types/src/altair/sszTypes.ts:
sync committees, participation flags, light-client protocol containers.
"""

from __future__ import annotations

from types import SimpleNamespace

from ..params import (
    CURRENT_SYNC_COMMITTEE_DEPTH,
    FINALIZED_ROOT_DEPTH,
    NEXT_SYNC_COMMITTEE_DEPTH,
    SYNC_COMMITTEE_SUBNET_COUNT,
)
from ..params.presets import Preset
from ..ssz import (
    BitVectorType,
    BLSPubkey,
    BLSSignature,
    Bytes32,
    ListType,
    VectorType,
    uint8,
    uint64,
)
from .phase0 import _container


def make_types(p: Preset, phase0: SimpleNamespace) -> SimpleNamespace:
    Root = Bytes32

    SyncCommittee = _container(
        "SyncCommittee",
        [
            ("pubkeys", VectorType(BLSPubkey, p.SYNC_COMMITTEE_SIZE)),
            ("aggregate_pubkey", BLSPubkey),
        ],
    )
    SyncAggregate = _container(
        "SyncAggregate",
        [
            ("sync_committee_bits", BitVectorType(p.SYNC_COMMITTEE_SIZE)),
            ("sync_committee_signature", BLSSignature),
        ],
    )
    SyncCommitteeMessage = _container(
        "SyncCommitteeMessage",
        [
            ("slot", uint64),
            ("beacon_block_root", Root),
            ("validator_index", uint64),
            ("signature", BLSSignature),
        ],
    )
    SyncCommitteeContribution = _container(
        "SyncCommitteeContribution",
        [
            ("slot", uint64),
            ("beacon_block_root", Root),
            ("subcommittee_index", uint64),
            (
                "aggregation_bits",
                BitVectorType(p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT),
            ),
            ("signature", BLSSignature),
        ],
    )
    ContributionAndProof = _container(
        "ContributionAndProof",
        [
            ("aggregator_index", uint64),
            ("contribution", SyncCommitteeContribution.ssz_type),
            ("selection_proof", BLSSignature),
        ],
    )
    SignedContributionAndProof = _container(
        "SignedContributionAndProof",
        [("message", ContributionAndProof.ssz_type), ("signature", BLSSignature)],
    )
    SyncAggregatorSelectionData = _container(
        "SyncAggregatorSelectionData",
        [("slot", uint64), ("subcommittee_index", uint64)],
    )

    BeaconBlockBody = _container(
        "BeaconBlockBody",
        phase0.BeaconBlockBody.fields + [("sync_aggregate", SyncAggregate.ssz_type)],
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

    # BeaconState: phase0 with pending attestations replaced by participation
    # flags, plus inactivity scores and sync committees.
    state_fields = []
    for name, typ in phase0.BeaconState.fields:
        if name == "previous_epoch_attestations":
            state_fields.append(
                ("previous_epoch_participation", ListType(uint8, p.VALIDATOR_REGISTRY_LIMIT))
            )
        elif name == "current_epoch_attestations":
            state_fields.append(
                ("current_epoch_participation", ListType(uint8, p.VALIDATOR_REGISTRY_LIMIT))
            )
        else:
            state_fields.append((name, typ))
    state_fields += [
        ("inactivity_scores", ListType(uint64, p.VALIDATOR_REGISTRY_LIMIT)),
        ("current_sync_committee", SyncCommittee.ssz_type),
        ("next_sync_committee", SyncCommittee.ssz_type),
    ]
    BeaconState = _container("BeaconState", state_fields)

    # --- light-client protocol (altair sync protocol; reference:
    # types/src/altair/sszTypes.ts LightClient* containers)
    LightClientBootstrap = _container(
        "LightClientBootstrap",
        [
            ("header", phase0.BeaconBlockHeader.ssz_type),
            ("current_sync_committee", SyncCommittee.ssz_type),
            ("current_sync_committee_branch", VectorType(Root, CURRENT_SYNC_COMMITTEE_DEPTH)),
        ],
    )
    LightClientUpdate = _container(
        "LightClientUpdate",
        [
            ("attested_header", phase0.BeaconBlockHeader.ssz_type),
            ("next_sync_committee", SyncCommittee.ssz_type),
            ("next_sync_committee_branch", VectorType(Root, NEXT_SYNC_COMMITTEE_DEPTH)),
            ("finalized_header", phase0.BeaconBlockHeader.ssz_type),
            ("finality_branch", VectorType(Root, FINALIZED_ROOT_DEPTH)),
            ("sync_aggregate", SyncAggregate.ssz_type),
            ("signature_slot", uint64),
        ],
    )
    LightClientFinalityUpdate = _container(
        "LightClientFinalityUpdate",
        [
            ("attested_header", phase0.BeaconBlockHeader.ssz_type),
            ("finalized_header", phase0.BeaconBlockHeader.ssz_type),
            ("finality_branch", VectorType(Root, FINALIZED_ROOT_DEPTH)),
            ("sync_aggregate", SyncAggregate.ssz_type),
            ("signature_slot", uint64),
        ],
    )
    LightClientOptimisticUpdate = _container(
        "LightClientOptimisticUpdate",
        [
            ("attested_header", phase0.BeaconBlockHeader.ssz_type),
            ("sync_aggregate", SyncAggregate.ssz_type),
            ("signature_slot", uint64),
        ],
    )

    Metadata = _container(
        "Metadata",
        phase0.Metadata.fields + [("syncnets", BitVectorType(SYNC_COMMITTEE_SUBNET_COUNT))],
    )

    # inherit unchanged phase0 containers, then overlay the altair ones
    # (reference: ssz.altair re-exports phase0 types it doesn't redefine)
    merged = {k: v for k, v in vars(phase0).items() if isinstance(v, type)}
    merged.update({k: v for k, v in locals().items() if isinstance(v, type)})
    return SimpleNamespace(**merged)
