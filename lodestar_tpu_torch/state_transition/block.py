"""phase0 block processing (spec process_block and operations).

Reference surface: `state-transition/src/block/` (processBlockHeader,
processRandao, processEth1Data, processOperations, processAttestation*,
processDeposit, processProposerSlashing, processAttesterSlashing,
processVoluntaryExit) — re-derived from the consensus spec, with committee
lookups served by the `EpochContext` and balances mutated on the flat
arrays.

The port's copy of `lodestar_tpu/state_transition/block.py`. Signature
verification is SEPARATE from state mutation: `verify_signatures`
controls inline verification on the C host tier (`bls.api` over
`native/`); the production path extracts all sets with
`signature_sets.get_block_signature_sets` and hands them to the device
batch verifier — the reference's `verifyBlocksSignatures` /
`getBlockSignatureSets` split (`chain/blocks/verifyBlocksSignatures.ts:28`).
Bellatrix and Capella blocks go on to `bellatrix.py` (the execution
payload) and `capella.py` (withdrawals, BLS-to-execution changes).
"""

from __future__ import annotations

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_VOLUNTARY_EXIT,
    FAR_FUTURE_EPOCH,
)
from ..ssz.hashing import sha256
from . import util


class BlockProcessingError(ValueError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise BlockProcessingError(msg)


# --- balance mutators (flat arrays are the compute representation) ----------

def increase_balance(cached, index: int, delta: int) -> None:
    cached.flat.balances[index] = int(cached.flat.balances[index]) + int(delta)


def decrease_balance(cached, index: int, delta: int) -> None:
    b = int(cached.flat.balances[index])
    cached.flat.balances[index] = max(0, b - int(delta))


# --- validator mutators -----------------------------------------------------

def initiate_validator_exit(cached, index: int) -> None:
    """Spec initiate_validator_exit with churn-limited exit queue."""
    flat, config, p = cached.flat, cached.config, cached.preset
    if int(flat.exit_epoch[index]) != FAR_FUTURE_EPOCH:
        return
    import numpy as np

    exiting = flat.exit_epoch[flat.exit_epoch != np.uint64(FAR_FUTURE_EPOCH)]
    activation_exit = util.compute_activation_exit_epoch(
        cached.current_epoch, p.MAX_SEED_LOOKAHEAD
    )
    exit_queue_epoch = max(
        int(exiting.max()) if len(exiting) else 0, activation_exit
    )
    churn = get_validator_churn_limit(cached)
    if int((flat.exit_epoch == np.uint64(exit_queue_epoch)).sum()) >= churn:
        exit_queue_epoch += 1
    flat.exit_epoch[index] = exit_queue_epoch
    flat.withdrawable_epoch[index] = (
        exit_queue_epoch + config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    )


def get_validator_churn_limit(cached) -> int:
    active = len(cached.epoch_ctx.current.active_indices)
    return max(
        cached.config.MIN_PER_EPOCH_CHURN_LIMIT,
        active // cached.config.CHURN_LIMIT_QUOTIENT,
    )


def min_slashing_penalty_quotient(cached) -> int:
    """Per-fork slashing penalty quotient (spec slash_validator variants)."""
    p = cached.preset
    if cached.is_execution:
        return p.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX
    if cached.is_altair:
        return p.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    return p.MIN_SLASHING_PENALTY_QUOTIENT


def slash_validator(cached, slashed_index: int, whistleblower_index: int | None = None):
    """Spec slash_validator (fork-aware penalty quotient + proposer cut)."""
    flat, p = cached.flat, cached.preset
    epoch = cached.current_epoch
    initiate_validator_exit(cached, slashed_index)
    flat.slashed[slashed_index] = True
    flat.withdrawable_epoch[slashed_index] = max(
        int(flat.withdrawable_epoch[slashed_index]),
        epoch + p.EPOCHS_PER_SLASHINGS_VECTOR,
    )
    eff = int(flat.effective_balance[slashed_index])
    state = cached.state
    idx = epoch % p.EPOCHS_PER_SLASHINGS_VECTOR
    state.slashings[idx] = state.slashings[idx] + eff
    decrease_balance(cached, slashed_index, eff // min_slashing_penalty_quotient(cached))

    proposer_index = cached.epoch_ctx.get_beacon_proposer(state.slot)
    whistleblower_reward = eff // p.WHISTLEBLOWER_REWARD_QUOTIENT
    if cached.is_altair:
        from ..params import PROPOSER_WEIGHT, WEIGHT_DENOMINATOR

        proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    else:
        proposer_reward = whistleblower_reward // p.PROPOSER_REWARD_QUOTIENT
    increase_balance(cached, proposer_index, proposer_reward)
    increase_balance(
        cached,
        whistleblower_index if whistleblower_index is not None else proposer_index,
        whistleblower_reward - proposer_reward,
    )


# --- block header / randao / eth1 ------------------------------------------

def process_block_header(cached, types, block) -> None:
    state = cached.state
    _require(block.slot == state.slot, "header slot mismatch")
    _require(
        block.slot > state.latest_block_header.slot, "header slot not newer"
    )
    proposer = cached.epoch_ctx.get_beacon_proposer(block.slot)
    _require(block.proposer_index == proposer, "wrong proposer index")
    _require(
        block.parent_root == state.latest_block_header.hash_tree_root(),
        "parent root mismatch",
    )
    _require(not bool(cached.flat.slashed[proposer]), "proposer slashed")
    state.latest_block_header = types.BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,
        body_root=block.body.hash_tree_root(),
    )


def process_randao(cached, body, verify_signatures: bool = True) -> None:
    state, p = cached.state, cached.preset
    epoch = cached.current_epoch
    if verify_signatures:
        proposer = cached.epoch_ctx.get_beacon_proposer(state.slot)
        domain = cached.config.get_domain(DOMAIN_RANDAO, state.slot)
        root = _epoch_signing_root(epoch, domain)
        pk = bls.PublicKey.from_bytes(bytes(cached.flat.pubkeys[proposer]))
        sig = bls.Signature.from_bytes(bytes(body.randao_reveal))
        _require(bls.verify(pk, root, sig), "invalid randao reveal")
    mix = util.get_randao_mix(state, epoch, p.EPOCHS_PER_HISTORICAL_VECTOR)
    new_mix = bytes(a ^ b for a, b in zip(mix, sha256(bytes(body.randao_reveal))))
    state.randao_mixes[epoch % p.EPOCHS_PER_HISTORICAL_VECTOR] = new_mix


def _epoch_signing_root(epoch: int, domain: bytes) -> bytes:
    from ..ssz import uint64

    return compute_signing_root(uint64.hash_tree_root(epoch), domain)


def process_eth1_data(cached, types, body) -> None:
    state, p = cached.state, cached.preset
    state.eth1_data_votes.append(body.eth1_data.copy())
    period_slots = p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH
    votes = sum(1 for v in state.eth1_data_votes if v == body.eth1_data)
    if votes * 2 > period_slots:
        state.eth1_data = body.eth1_data.copy()


# --- operations -------------------------------------------------------------

def is_slashable_validator(flat, index: int, epoch: int) -> bool:
    return (
        not bool(flat.slashed[index])
        and int(flat.activation_epoch[index]) <= epoch
        and epoch < int(flat.withdrawable_epoch[index])
    )


def is_slashable_attestation_data(d1, d2) -> bool:
    # double vote or surround vote
    return (
        d1 != d2 and d1.target.epoch == d2.target.epoch
    ) or (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )


def is_valid_indexed_attestation(
    cached, indexed, verify_signature: bool = True
) -> bool:
    indices = list(indexed.attesting_indices)
    if not indices or indices != sorted(set(indices)):
        return False
    if any(i >= len(cached.flat) for i in indices):
        return False
    if not verify_signature:
        return True
    domain = cached.config.get_domain(
        DOMAIN_BEACON_ATTESTER,
        util.compute_start_slot_at_epoch(
            indexed.data.target.epoch, cached.preset.SLOTS_PER_EPOCH
        ),
        indexed.data.target.epoch,
    )
    root = compute_signing_root(indexed.data.hash_tree_root(), domain)
    pks = [
        bls.PublicKey.from_bytes(bytes(cached.flat.pubkeys[i])) for i in indices
    ]
    sig = bls.Signature.from_bytes(bytes(indexed.signature), validate=False)
    return bls.fast_aggregate_verify(pks, root, sig)


def get_attesting_indices(cached, data, aggregation_bits) -> list[int]:
    committee = cached.epoch_ctx.get_beacon_committee(data.slot, data.index)
    _require(
        len(aggregation_bits) == len(committee), "aggregation bits length mismatch"
    )
    return sorted(int(committee[i]) for i, bit in enumerate(aggregation_bits) if bit)


def process_proposer_slashing(cached, op, verify_signatures: bool = True) -> None:
    h1, h2 = op.signed_header_1.message, op.signed_header_2.message
    _require(h1.slot == h2.slot, "slashing headers different slots")
    _require(h1.proposer_index == h2.proposer_index, "different proposers")
    _require(h1 != h2, "headers identical")
    idx = h1.proposer_index
    _require(idx < len(cached.flat), "unknown proposer")
    _require(
        is_slashable_validator(cached.flat, idx, cached.current_epoch),
        "proposer not slashable",
    )
    if verify_signatures:
        for signed in (op.signed_header_1, op.signed_header_2):
            domain = cached.config.get_domain(
                DOMAIN_BEACON_PROPOSER, signed.message.slot
            )
            root = compute_signing_root(signed.message.hash_tree_root(), domain)
            pk = bls.PublicKey.from_bytes(bytes(cached.flat.pubkeys[idx]))
            _require(
                bls.verify(pk, root, bls.Signature.from_bytes(bytes(signed.signature))),
                "bad proposer slashing signature",
            )
    slash_validator(cached, idx)


def process_attester_slashing(cached, op, verify_signatures: bool = True) -> None:
    a1, a2 = op.attestation_1, op.attestation_2
    _require(
        is_slashable_attestation_data(a1.data, a2.data), "not slashable pair"
    )
    _require(
        is_valid_indexed_attestation(cached, a1, verify_signatures),
        "attestation_1 invalid",
    )
    _require(
        is_valid_indexed_attestation(cached, a2, verify_signatures),
        "attestation_2 invalid",
    )
    slashed_any = False
    common = set(a1.attesting_indices) & set(a2.attesting_indices)
    for idx in sorted(common):
        if is_slashable_validator(cached.flat, idx, cached.current_epoch):
            slash_validator(cached, idx)
            slashed_any = True
    _require(slashed_any, "no validator slashed")


def process_attestation(cached, types, attestation, verify_signatures: bool = True):
    state, p = cached.state, cached.preset
    data = attestation.data
    _require(
        data.target.epoch in (cached.previous_epoch, cached.current_epoch),
        "target epoch out of range",
    )
    _require(
        data.target.epoch
        == util.compute_epoch_at_slot(data.slot, p.SLOTS_PER_EPOCH),
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
    committee = cached.epoch_ctx.get_beacon_committee(data.slot, data.index)
    _require(
        len(attestation.aggregation_bits) == len(committee),
        "bits/committee length mismatch",
    )
    pending = types.PendingAttestation(
        aggregation_bits=list(attestation.aggregation_bits),
        data=data.copy(),
        inclusion_delay=state.slot - data.slot,
        proposer_index=cached.epoch_ctx.get_beacon_proposer(state.slot),
    )
    if data.target.epoch == cached.current_epoch:
        _require(
            data.source == state.current_justified_checkpoint,
            "wrong source (current)",
        )
        state.current_epoch_attestations.append(pending)
    else:
        _require(
            data.source == state.previous_justified_checkpoint,
            "wrong source (previous)",
        )
        state.previous_epoch_attestations.append(pending)
    if verify_signatures:
        indexed = types.IndexedAttestation(
            attesting_indices=get_attesting_indices(
                cached, data, attestation.aggregation_bits
            ),
            data=data.copy(),
            signature=bytes(attestation.signature),
        )
        _require(
            is_valid_indexed_attestation(cached, indexed, True),
            "bad attestation signature",
        )


def apply_deposit_data(
    config, types, state, data, pubkey_index: dict | None = None, sig_ok: bool | None = None
) -> None:
    """Add new validator or top-up (spec process_deposit tail). Standalone
    (no cache): also used at genesis. Deposit signatures are verified here
    for NEW validators only (spec: invalid-sig deposits are skipped, not
    failed).

    `pubkey_index` (pubkey → validator index of `state`, kept up to date
    here) replaces the scan of every validator's key; `sig_ok` is the
    deposit's signature verdict when the caller has it already."""
    p = config.preset
    pubkey = bytes(data.pubkey)
    if pubkey_index is None:
        pubkey_index = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    if pubkey not in pubkey_index:
        if sig_ok is None:
            sig_ok = _deposit_signature_ok(config, types, data)
        if not sig_ok:
            return  # skip, don't fail
        amount = data.amount
        eff = min(
            amount - amount % p.EFFECTIVE_BALANCE_INCREMENT, p.MAX_EFFECTIVE_BALANCE
        )
        state.validators.append(
            types.Validator(
                pubkey=pubkey,
                withdrawal_credentials=bytes(data.withdrawal_credentials),
                effective_balance=eff,
                slashed=False,
                activation_eligibility_epoch=FAR_FUTURE_EPOCH,
                activation_epoch=FAR_FUTURE_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
        state.balances.append(amount)
        pubkey_index[pubkey] = len(state.validators) - 1
    else:
        idx = pubkey_index[pubkey]
        state.balances[idx] = state.balances[idx] + data.amount


def _deposit_signature_ok(config, types, data) -> bool:
    from ..config.beacon_config import compute_domain

    domain = compute_domain(DOMAIN_DEPOSIT, config.GENESIS_FORK_VERSION, b"\x00" * 32)
    msg = types.DepositMessage(
        pubkey=bytes(data.pubkey),
        withdrawal_credentials=bytes(data.withdrawal_credentials),
        amount=data.amount,
    )
    root = compute_signing_root(msg.hash_tree_root(), domain)
    try:
        pk = bls.PublicKey.from_bytes(bytes(data.pubkey))
        sig = bls.Signature.from_bytes(bytes(data.signature))
    except (bls.BlsError, ValueError):
        return False
    return bls.verify(pk, root, sig)


def process_deposit(cached, types, deposit) -> None:
    state = cached.state
    _require(
        util.is_valid_merkle_branch(
            deposit.data.hash_tree_root(),
            list(deposit.proof),
            DEPOSIT_CONTRACT_TREE_DEPTH + 1,
            state.eth1_deposit_index,
            state.eth1_data.deposit_root,
        ),
        "invalid deposit proof",
    )
    state.eth1_deposit_index += 1
    n_before = len(state.validators)
    known = cached.epoch_ctx.pubkey_to_index.get(bytes(deposit.data.pubkey))
    # the epoch context's index mirrors state.validators; a new validator
    # lands in it here, so sync_pubkeys below finds nothing left to add
    apply_deposit_data(
        cached.config, types, state, deposit.data, cached.epoch_ctx.pubkey_to_index
    )
    if len(state.validators) > n_before:
        v = state.validators[-1]
        cached.flat.append(v, state.balances[-1])
        cached.epoch_ctx.sync_pubkeys(cached.flat)
    elif known is not None:
        # top-up: refresh the flat balance column for that validator
        cached.flat.balances[known] = state.balances[known]


def process_voluntary_exit(cached, signed_exit, verify_signatures: bool = True):
    exit_msg = signed_exit.message
    flat = cached.flat
    idx = exit_msg.validator_index
    _require(idx < len(flat), "unknown validator")
    _require(
        bool(
            util.active_mask(
                flat.activation_epoch[idx : idx + 1],
                flat.exit_epoch[idx : idx + 1],
                cached.current_epoch,
            )[0]
        ),
        "validator not active",
    )
    _require(
        int(flat.exit_epoch[idx]) == FAR_FUTURE_EPOCH, "exit already initiated"
    )
    _require(cached.current_epoch >= exit_msg.epoch, "exit epoch in future")
    _require(
        cached.current_epoch
        >= int(flat.activation_epoch[idx]) + cached.config.SHARD_COMMITTEE_PERIOD,
        "validator too young to exit",
    )
    if verify_signatures:
        domain = cached.config.get_domain(
            DOMAIN_VOLUNTARY_EXIT,
            util.compute_start_slot_at_epoch(
                exit_msg.epoch, cached.preset.SLOTS_PER_EPOCH
            ),
            exit_msg.epoch,
        )
        root = compute_signing_root(exit_msg.hash_tree_root(), domain)
        pk = bls.PublicKey.from_bytes(bytes(flat.pubkeys[idx]))
        _require(
            bls.verify(
                pk, root, bls.Signature.from_bytes(bytes(signed_exit.signature))
            ),
            "bad exit signature",
        )
    initiate_validator_exit(cached, idx)


def process_operations(cached, types, body, verify_signatures: bool = True) -> None:
    state, p = cached.state, cached.preset
    expected_deposits = min(
        p.MAX_DEPOSITS,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    _require(
        len(body.deposits) == expected_deposits, "wrong number of deposits"
    )
    for op in body.proposer_slashings:
        process_proposer_slashing(cached, op, verify_signatures)
    for op in body.attester_slashings:
        process_attester_slashing(cached, op, verify_signatures)
    if cached.is_altair:
        from .altair import process_attestation_altair

        for op in body.attestations:
            process_attestation_altair(cached, types, op, verify_signatures)
    else:
        for op in body.attestations:
            process_attestation(cached, types, op, verify_signatures)
    for op in body.deposits:
        process_deposit(cached, types, op)
    for op in body.voluntary_exits:
        process_voluntary_exit(cached, op, verify_signatures)
    if cached.is_capella:
        from .capella import process_bls_to_execution_change

        for op in body.bls_to_execution_changes:
            process_bls_to_execution_change(cached, op, verify_signatures)


def process_block(
    cached, types, block, verify_signatures: bool = True, execution_engine=None
) -> None:
    process_block_header(cached, types, block)
    if cached.is_execution:
        from .bellatrix import is_execution_enabled, process_execution_payload

        if is_execution_enabled(cached.state, block.body):
            if cached.is_capella:
                from .capella import process_withdrawals

                process_withdrawals(cached, types, block.body.execution_payload)
            process_execution_payload(cached, types, block.body, execution_engine)
    process_randao(cached, block.body, verify_signatures)
    process_eth1_data(cached, types, block.body)
    process_operations(cached, types, block.body, verify_signatures)
    if cached.is_altair and hasattr(block.body, "sync_aggregate"):
        from .altair import process_sync_aggregate

        process_sync_aggregate(cached, block.body.sync_aggregate, verify_signatures)
