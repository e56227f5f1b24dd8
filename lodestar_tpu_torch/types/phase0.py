"""phase0 SSZ container types.

Equivalent of packages/types/src/phase0/sszTypes.ts. Field
names and order follow the consensus spec exactly (merkle roots depend on
them). Types are built per-preset because list lengths/limits are preset
quantities.
"""

from __future__ import annotations

from types import SimpleNamespace

from ..params import ATTESTATION_SUBNET_COUNT, DEPOSIT_CONTRACT_TREE_DEPTH, JUSTIFICATION_BITS_LENGTH
from ..params.presets import Preset
from ..ssz import (
    BitListType,
    BitVectorType,
    BLSPubkey,
    BLSSignature,
    Bytes4,
    Bytes32,
    Container,
    ListType,
    VectorType,
    boolean,
    uint64,
)


def _container(name: str, fields: list) -> type[Container]:
    return type(name, (Container,), {"fields": fields})


def make_types(p: Preset) -> SimpleNamespace:
    Root = Bytes32

    Fork = _container(
        "Fork",
        [
            ("previous_version", Bytes4),
            ("current_version", Bytes4),
            ("epoch", uint64),
        ],
    )
    ForkData = _container(
        "ForkData",
        [("current_version", Bytes4), ("genesis_validators_root", Root)],
    )
    SigningData = _container(
        "SigningData", [("object_root", Root), ("domain", Bytes32)]
    )
    Checkpoint = _container("Checkpoint", [("epoch", uint64), ("root", Root)])
    Validator = _container(
        "Validator",
        [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("effective_balance", uint64),
            ("slashed", boolean),
            ("activation_eligibility_epoch", uint64),
            ("activation_epoch", uint64),
            ("exit_epoch", uint64),
            ("withdrawable_epoch", uint64),
        ],
    )
    AttestationData = _container(
        "AttestationData",
        [
            ("slot", uint64),
            ("index", uint64),
            ("beacon_block_root", Root),
            ("source", Checkpoint.ssz_type),
            ("target", Checkpoint.ssz_type),
        ],
    )
    CommitteeBits = BitListType(p.MAX_VALIDATORS_PER_COMMITTEE)
    IndexedAttestation = _container(
        "IndexedAttestation",
        [
            ("attesting_indices", ListType(uint64, p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData.ssz_type),
            ("signature", BLSSignature),
        ],
    )
    PendingAttestation = _container(
        "PendingAttestation",
        [
            ("aggregation_bits", CommitteeBits),
            ("data", AttestationData.ssz_type),
            ("inclusion_delay", uint64),
            ("proposer_index", uint64),
        ],
    )
    Attestation = _container(
        "Attestation",
        [
            ("aggregation_bits", CommitteeBits),
            ("data", AttestationData.ssz_type),
            ("signature", BLSSignature),
        ],
    )
    AggregateAndProof = _container(
        "AggregateAndProof",
        [
            ("aggregator_index", uint64),
            ("aggregate", Attestation.ssz_type),
            ("selection_proof", BLSSignature),
        ],
    )
    SignedAggregateAndProof = _container(
        "SignedAggregateAndProof",
        [("message", AggregateAndProof.ssz_type), ("signature", BLSSignature)],
    )
    Eth1Data = _container(
        "Eth1Data",
        [
            ("deposit_root", Root),
            ("deposit_count", uint64),
            ("block_hash", Bytes32),
        ],
    )
    HistoricalBatch = _container(
        "HistoricalBatch",
        [
            ("block_roots", VectorType(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", VectorType(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
        ],
    )
    DepositMessage = _container(
        "DepositMessage",
        [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("amount", uint64),
        ],
    )
    DepositData = _container(
        "DepositData",
        [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("amount", uint64),
            ("signature", BLSSignature),
        ],
    )
    Deposit = _container(
        "Deposit",
        [
            ("proof", VectorType(Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
            ("data", DepositData.ssz_type),
        ],
    )
    BeaconBlockHeader = _container(
        "BeaconBlockHeader",
        [
            ("slot", uint64),
            ("proposer_index", uint64),
            ("parent_root", Root),
            ("state_root", Root),
            ("body_root", Root),
        ],
    )
    SignedBeaconBlockHeader = _container(
        "SignedBeaconBlockHeader",
        [("message", BeaconBlockHeader.ssz_type), ("signature", BLSSignature)],
    )
    ProposerSlashing = _container(
        "ProposerSlashing",
        [
            ("signed_header_1", SignedBeaconBlockHeader.ssz_type),
            ("signed_header_2", SignedBeaconBlockHeader.ssz_type),
        ],
    )
    AttesterSlashing = _container(
        "AttesterSlashing",
        [
            ("attestation_1", IndexedAttestation.ssz_type),
            ("attestation_2", IndexedAttestation.ssz_type),
        ],
    )
    VoluntaryExit = _container(
        "VoluntaryExit", [("epoch", uint64), ("validator_index", uint64)]
    )
    SignedVoluntaryExit = _container(
        "SignedVoluntaryExit",
        [("message", VoluntaryExit.ssz_type), ("signature", BLSSignature)],
    )
    BeaconBlockBody = _container(
        "BeaconBlockBody",
        [
            ("randao_reveal", BLSSignature),
            ("eth1_data", Eth1Data.ssz_type),
            ("graffiti", Bytes32),
            ("proposer_slashings", ListType(ProposerSlashing.ssz_type, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", ListType(AttesterSlashing.ssz_type, p.MAX_ATTESTER_SLASHINGS)),
            ("attestations", ListType(Attestation.ssz_type, p.MAX_ATTESTATIONS)),
            ("deposits", ListType(Deposit.ssz_type, p.MAX_DEPOSITS)),
            ("voluntary_exits", ListType(SignedVoluntaryExit.ssz_type, p.MAX_VOLUNTARY_EXITS)),
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
    BeaconState = _container(
        "BeaconState",
        [
            ("genesis_time", uint64),
            ("genesis_validators_root", Root),
            ("slot", uint64),
            ("fork", Fork.ssz_type),
            ("latest_block_header", BeaconBlockHeader.ssz_type),
            ("block_roots", VectorType(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", VectorType(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("historical_roots", ListType(Root, p.HISTORICAL_ROOTS_LIMIT)),
            ("eth1_data", Eth1Data.ssz_type),
            (
                "eth1_data_votes",
                ListType(Eth1Data.ssz_type, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH),
            ),
            ("eth1_deposit_index", uint64),
            ("validators", ListType(Validator.ssz_type, p.VALIDATOR_REGISTRY_LIMIT)),
            ("balances", ListType(uint64, p.VALIDATOR_REGISTRY_LIMIT)),
            ("randao_mixes", VectorType(Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR)),
            ("slashings", VectorType(uint64, p.EPOCHS_PER_SLASHINGS_VECTOR)),
            (
                "previous_epoch_attestations",
                ListType(PendingAttestation.ssz_type, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH),
            ),
            (
                "current_epoch_attestations",
                ListType(PendingAttestation.ssz_type, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH),
            ),
            ("justification_bits", BitVectorType(JUSTIFICATION_BITS_LENGTH)),
            ("previous_justified_checkpoint", Checkpoint.ssz_type),
            ("current_justified_checkpoint", Checkpoint.ssz_type),
            ("finalized_checkpoint", Checkpoint.ssz_type),
        ],
    )

    # --- p2p wire types (reference: types/src/phase0/sszTypes.ts Status etc.)
    Status = _container(
        "Status",
        [
            ("fork_digest", Bytes4),
            ("finalized_root", Root),
            ("finalized_epoch", uint64),
            ("head_root", Root),
            ("head_slot", uint64),
        ],
    )
    Metadata = _container(
        "Metadata",
        [("seq_number", uint64), ("attnets", BitVectorType(ATTESTATION_SUBNET_COUNT))],
    )

    Eth1Block = _container(
        "Eth1Block",
        [("timestamp", uint64), ("deposit_root", Root), ("deposit_count", uint64)],
    )

    return SimpleNamespace(**{k: v for k, v in locals().items() if isinstance(v, type)})
