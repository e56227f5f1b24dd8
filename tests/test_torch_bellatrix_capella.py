"""The port's Bellatrix and Capella state transition (`bellatrix.py`,
`capella.py`, `weak_subjectivity.py` and their call sites in `stf`,
`block`, `altair` and `signature_sets`) against the JAX package's, on the
minimal preset with 16 interop validators (helpers in
`torch_capella.py`): the cases of the JAX `tests/test_bellatrix_capella.py`
run in both packages, each block made and signed by the port and carried
to the JAX package through its SSZ bytes, the state roots compared after
every block, slot run and epoch boundary. JAX runs with
`verify_signatures=False` where a block's sets would go to its oracle;
the port checks every signature inline on the C host tier. Tolerance:
bytes equal."""

import numpy as np
import pytest
import torch_capella as tc

from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import process_slots as j_process_slots
from lodestar_tpu.state_transition import state_transition as j_state_transition
from lodestar_tpu.state_transition import weak_subjectivity as jws
from lodestar_tpu.state_transition.block import BlockProcessingError as JBlockProcessingError
from lodestar_tpu.state_transition.capella import (
    get_expected_withdrawals as j_expected_withdrawals,
)
from lodestar_tpu.state_transition.capella import (
    process_bls_to_execution_change as j_process_change,
)
from lodestar_tpu.state_transition.capella import process_withdrawals as j_process_withdrawals
from lodestar_tpu.state_transition.signature_sets import (
    get_block_signature_sets as j_block_sets,
)
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.convert import ssz_from_jax
from lodestar_tpu_torch.params import ForkName
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import process_slots, state_transition
from lodestar_tpu_torch.state_transition import weak_subjectivity as ws
from lodestar_tpu_torch.state_transition.bellatrix import (
    compute_timestamp_at_slot,
    get_randao_mix,
    is_execution_enabled,
    is_merge_transition_complete,
)
from lodestar_tpu_torch.state_transition.block import BlockProcessingError
from lodestar_tpu_torch.state_transition.capella import (
    get_expected_withdrawals,
    is_fully_withdrawable_validator,
    is_partially_withdrawable_validator,
    process_bls_to_execution_change,
    process_withdrawals,
)
from lodestar_tpu_torch.state_transition.signature_sets import get_block_signature_sets
from lodestar_tpu_torch.types import get_types

SPE = tc.SPE
SEED = 18


@pytest.fixture(scope="module")
def scheduled():
    """(port config, port Altair genesis, JAX config, JAX Altair genesis)
    under Bellatrix at epoch 1 and Capella at 2."""
    return tc.altair_pair()


def triples(sets):
    return [(s.pubkey.to_bytes(), bytes(s.message), bytes(s.signature)) for s in sets]


def both(scheduled):
    config, state, jconfig, jstate = scheduled
    return tc.port_cached(config, state), tc.JCached(jconfig, jstate.copy(), JMINIMAL)


def apply_both(cached, jcached, signed, verify_state_root=True):
    """The port block through both packages' state transition (the port
    checking signatures inline); the post-state roots must agree."""
    types = get_types(MINIMAL).by_fork[cached.fork]
    state_transition(cached, types, signed, verify_state_root=verify_state_root,
                     verify_signatures=True)
    j_state_transition(jcached, jget_types(JMINIMAL).by_fork[jcached.fork], tc.to_jax(signed),
                       verify_state_root=verify_state_root, verify_signatures=False)
    assert cached.hash_tree_root() == jcached.hash_tree_root()


def test_the_genesis_is_the_jax_one(scheduled):
    config, state, jconfig, jstate = scheduled
    assert state.serialize() == jstate.serialize()
    assert bytes(config.BELLATRIX_FORK_VERSION) == bytes(jconfig.BELLATRIX_FORK_VERSION)


def test_scheduled_upgrades_in_process_slots(scheduled):
    cached, jcached = both(scheduled)
    t, jt = get_types(MINIMAL), jget_types(JMINIMAL)
    for slot, fork in ((SPE - 1, ForkName.altair), (SPE, ForkName.bellatrix),
                       (2 * SPE, ForkName.capella), (3 * SPE + 1, ForkName.capella)):
        process_slots(cached, t.by_fork[cached.fork], slot)
        j_process_slots(jcached, jt.by_fork[jcached.fork], slot)
        assert cached.fork == fork == jcached.fork
        assert cached.hash_tree_root() == jcached.hash_tree_root(), slot
        cached.sync_flat()
        jcached.sync_flat()
        assert cached.state.serialize() == jcached.state.serialize(), slot
    state = cached.state
    assert bytes(state.fork.current_version) == cached.config.CAPELLA_FORK_VERSION
    assert state.next_withdrawal_index == state.next_withdrawal_validator_index == 0
    assert len(state.historical_summaries) == 0
    assert not is_merge_transition_complete(state)
    assert len(state.previous_epoch_participation) == tc.N


def test_bellatrix_pre_merge_blocks(scheduled):
    cached, jcached = both(scheduled)
    process_slots(cached, get_types(MINIMAL).altair, SPE)
    j_process_slots(jcached, jget_types(JMINIMAL).altair, SPE)
    for slot in (SPE + 1, SPE + 2):
        signed = tc.produce_block(cached.config, cached, slot)
        assert not is_execution_enabled(cached.state, signed.message.body)
        apply_both(cached, jcached, signed)
    assert cached.fork == ForkName.bellatrix and not is_merge_transition_complete(cached.state)


def merge_payload(config, cached):
    """A structurally valid merge-transition payload for `cached`'s slot."""
    state = cached.state
    return get_types(MINIMAL).bellatrix.ExecutionPayload(
        parent_hash=b"\x11" * 32, fee_recipient=b"\x22" * 20, state_root=b"\x33" * 32,
        receipts_root=b"\x44" * 32,
        prev_randao=get_randao_mix(state, cached.current_epoch, cached.preset),
        block_number=1, gas_limit=30_000_000, gas_used=21_000,
        timestamp=compute_timestamp_at_slot(config, state), base_fee_per_gas=7,
        block_hash=b"\x55" * 32, transactions=[b"\x01\x02"])


def test_bellatrix_merge_transition_block(scheduled):
    cached, jcached = both(scheduled)
    t = get_types(MINIMAL).by_fork
    process_slots(cached, t[cached.fork], SPE + 1)
    j_process_slots(jcached, jget_types(JMINIMAL).by_fork[jcached.fork], SPE + 1)
    signed = tc.produce_block(cached.config, cached, SPE + 1,
                              payload=merge_payload(cached.config, cached))
    assert is_execution_enabled(cached.state, signed.message.body)
    apply_both(cached, jcached, signed)
    assert is_merge_transition_complete(cached.state)
    header = cached.state.latest_execution_payload_header
    assert bytes(header.block_hash) == b"\x55" * 32 and header.block_number == 1
    assert header.serialize() == jcached.state.latest_execution_payload_header.serialize()
    # a second payload must chain on the first: a wrong parent is refused by both
    slot = SPE + 2
    process_slots(cached, t[cached.fork], slot)
    j_process_slots(jcached, jget_types(JMINIMAL).by_fork[jcached.fork], slot)
    good = merge_payload(cached.config, cached)
    good.parent_hash, good.block_hash, good.block_number = b"\x55" * 32, b"\x66" * 32, 2
    bad_block = tc.produce_block(cached.config, cached, slot, payload=good)
    bad_block.message.body.execution_payload = merge_payload(cached.config, cached)
    with pytest.raises(BlockProcessingError, match="parent hash"):
        state_transition(cached.copy(), t[cached.fork], bad_block, verify_state_root=False,
                         verify_signatures=False)
    with pytest.raises(JBlockProcessingError, match="parent hash"):
        j_state_transition(jcached.copy(), jget_types(JMINIMAL).by_fork[jcached.fork],
                           tc.to_jax(bad_block), verify_state_root=False,
                           verify_signatures=False)


def _capella_at(scheduled, slot=2 * SPE):
    cached, jcached = both(scheduled)
    process_slots(cached, get_types(MINIMAL).altair, slot)
    j_process_slots(jcached, jget_types(JMINIMAL).altair, slot)
    assert cached.fork == ForkName.capella
    return cached, jcached


def _withdrawal_tuples(ws_):
    return [(w.index, w.validator_index, bytes(w.address), w.amount) for w in ws_]


def test_capella_withdrawals_sweep(scheduled):
    cached, _ = _capella_at(scheduled)
    rng = np.random.default_rng(SEED)
    state = cached.state
    # validator 0 fully withdrawable, 1 partially, then a seeded mix
    state.validators[0].withdrawal_credentials = tc.eth1_credential(b"\xaa" * 20)
    state.validators[0].withdrawable_epoch = 0
    state.validators[1].withdrawal_credentials = tc.eth1_credential(b"\xbb" * 20)
    state.balances[1] = MINIMAL.MAX_EFFECTIVE_BALANCE + 123
    for v in rng.choice(np.arange(2, tc.N), 8, replace=False).tolist():
        state.validators[v].withdrawal_credentials = tc.eth1_credential(rng.bytes(20))
        state.balances[v] = MINIMAL.MAX_EFFECTIVE_BALANCE + int(rng.integers(0, 10**6))
    state.next_withdrawal_validator_index = 5
    state.next_withdrawal_index = 7
    cached.reload_state(state)
    jcached = tc.jax_cached(scheduled[2], cached)
    t, jt = get_types(MINIMAL).capella, jget_types(JMINIMAL).capella
    ours = get_expected_withdrawals(cached, t)
    assert _withdrawal_tuples(ours) == _withdrawal_tuples(j_expected_withdrawals(jcached, jt))
    assert len(ours) == MINIMAL.MAX_WITHDRAWALS_PER_PAYLOAD
    by_validator = {w.validator_index: w for w in get_expected_withdrawals(
        tc.port_cached(cached.config, _cursor(state, 0)), t)}
    assert by_validator[0].amount == int(cached.flat.balances[0])
    assert by_validator[1].amount == 123 and bytes(by_validator[0].address) == b"\xaa" * 20
    # process them: balances and cursors as in JAX
    payload = t.ExecutionPayload(withdrawals=ours)
    process_withdrawals(cached, t, payload)
    j_process_withdrawals(jcached, jt, tc.to_jax_payload(payload))
    assert cached.hash_tree_root() == jcached.hash_tree_root()
    assert cached.state.next_withdrawal_index == 7 + len(ours)
    # a payload that disagrees with the sweep is refused
    wrong = t.ExecutionPayload(withdrawals=get_expected_withdrawals(cached, t)[:-1])
    with pytest.raises(BlockProcessingError, match="withdrawals"):
        process_withdrawals(cached.copy(), t, wrong)


def _cursor(state, at):
    state = state.copy()
    state.next_withdrawal_validator_index = at
    return state


@pytest.fixture(scope="module")
def small_registry():
    """A Capella genesis of 12 validators in both packages: fewer than
    minimal's sweep bound of 16."""
    return tc.capella_pair(12, withdrawing=())


@pytest.mark.parametrize("start", [0, 5, 11])
@pytest.mark.parametrize("partial", [(), (3,), (2, 9)])
def test_sweep_cursor_on_a_registry_smaller_than_the_sweep(small_registry, start, partial):
    """A payload with fewer than MAX_WITHDRAWALS_PER_PAYLOAD withdrawals
    moves the cursor by min(12, 16), as in JAX (the spec would move it by
    16, to start + 4)."""
    config, state, jconfig, _ = small_registry
    state = state.copy()
    for v in partial:
        state.validators[v].withdrawal_credentials = tc.eth1_credential(bytes([v]) * 20)
        state.balances[v] = MINIMAL.MAX_EFFECTIVE_BALANCE + 1000 * (v + 1)
    state.next_withdrawal_validator_index = start
    cached = tc.port_cached(config, state)
    jcached = tc.jax_cached(jconfig, cached)
    t, jt = get_types(MINIMAL).capella, jget_types(JMINIMAL).capella
    ours = get_expected_withdrawals(cached, t)
    assert _withdrawal_tuples(ours) == _withdrawal_tuples(j_expected_withdrawals(jcached, jt))
    assert len(ours) == len(partial) < MINIMAL.MAX_WITHDRAWALS_PER_PAYLOAD
    payload = t.ExecutionPayload(withdrawals=ours)
    process_withdrawals(cached, t, payload)
    j_process_withdrawals(jcached, jt, tc.to_jax_payload(payload))
    assert cached.state.next_withdrawal_validator_index \
        == jcached.state.next_withdrawal_validator_index == start
    assert cached.hash_tree_root() == jcached.hash_tree_root()


def _loop_sweep(cached):
    """The spec's loop over the registry with the port's predicates: the
    reference of the sweep's numpy form."""
    state, p, flat = cached.state, cached.preset, cached.flat
    n, v = len(flat), state.next_withdrawal_validator_index
    out = []
    for _ in range(min(n, p.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)):
        wc, balance = flat.withdrawal_credentials[v].tobytes(), int(flat.balances[v])
        if is_fully_withdrawable_validator(wc, int(flat.withdrawable_epoch[v]), balance,
                                           cached.current_epoch):
            out.append((v, balance))
        elif is_partially_withdrawable_validator(wc, int(flat.effective_balance[v]), balance, p):
            out.append((v, balance - p.MAX_EFFECTIVE_BALANCE))
        if len(out) == p.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        v = (v + 1) % n
    return out


@pytest.mark.parametrize("seed", range(4))
def test_the_sweep_is_the_spec_loop(scheduled, seed):
    """Seeded registries (eth1 or BLS credentials, withdrawable or not,
    excess or none, any cursor): the numpy sweep gives the loop's
    withdrawals and the JAX package's."""
    cached, _ = _capella_at(scheduled)
    rng = np.random.default_rng(SEED + seed)
    flat, n, p = cached.flat, len(cached.flat), MINIMAL
    flat.withdrawal_credentials[:, 0] = rng.integers(0, 2, n)
    flat.withdrawable_epoch[:] = rng.choice(np.array([0, 2, 3, 2**64 - 1], np.uint64), n)
    flat.effective_balance[:] = rng.choice([p.MAX_EFFECTIVE_BALANCE, 31 * 10**9], n)
    flat.balances[:] = flat.effective_balance + rng.choice([0, 0, 7, 10**9], n).astype(np.uint64)
    flat.balances[rng.integers(0, n)] = 0
    cached.state.next_withdrawal_validator_index = int(rng.integers(0, n))
    want = _loop_sweep(cached)
    assert want
    ours = get_expected_withdrawals(cached, get_types(MINIMAL).capella)
    assert [(w.validator_index, w.amount) for w in ours] == want
    jcached = tc.jax_cached(scheduled[2], cached)
    assert _withdrawal_tuples(ours) == _withdrawal_tuples(
        j_expected_withdrawals(jcached, jget_types(JMINIMAL).capella))


def test_capella_bls_to_execution_change(scheduled):
    cached, jcached = _capella_at(scheduled)
    jt = jget_types(JMINIMAL).capella
    change = tc.signed_change(cached.config, cached, 3, b"\xcc" * 20)
    process_bls_to_execution_change(cached, change, verify_signatures=True)
    j_process_change(jcached, ssz_to_jax_change(change, jt), verify_signatures=True)
    wc = bytes(cached.state.validators[3].withdrawal_credentials)
    assert wc[:1] == b"\x01" and wc[12:] == b"\xcc" * 20
    assert cached.flat.withdrawal_credentials[3].tobytes() == wc
    assert cached.hash_tree_root() == jcached.hash_tree_root()
    # signed by another key: both refuse it
    bad = tc.signed_change(cached.config, cached, 4, b"\xdd" * 20, signer=3)
    with pytest.raises(BlockProcessingError, match="signature"):
        process_bls_to_execution_change(cached, bad, verify_signatures=True)
    with pytest.raises(JBlockProcessingError, match="signature"):
        j_process_change(jcached, ssz_to_jax_change(bad, jt), verify_signatures=True)
    # a second change of the same validator: its credential is no longer BLS
    again = tc.signed_change(cached.config, cached, 3, b"\xee" * 20)
    with pytest.raises(BlockProcessingError, match="not a BLS credential"):
        process_bls_to_execution_change(cached, again, verify_signatures=False)
    with pytest.raises(JBlockProcessingError, match="not a BLS credential"):
        j_process_change(jcached, ssz_to_jax_change(again, jt), verify_signatures=False)
    # a key that is not the credential's: refused before any signature check
    t = get_types(MINIMAL).capella
    foreign = t.SignedBLSToExecutionChange(
        message=t.BLSToExecutionChange(validator_index=6,
                                       from_bls_pubkey=tc.sk(7).to_public_key().to_bytes(),
                                       to_execution_address=b"\x01" * 20),
        signature=bytes(bad.signature))
    with pytest.raises(BlockProcessingError, match="from_bls_pubkey"):
        process_bls_to_execution_change(cached, foreign, verify_signatures=False)
    with pytest.raises(JBlockProcessingError, match="from_bls_pubkey"):
        j_process_change(jcached, ssz_to_jax_change(foreign, jt), verify_signatures=False)
    assert cached.hash_tree_root() == jcached.hash_tree_root()


def ssz_to_jax_change(change, jt):
    return jt.SignedBLSToExecutionChange.deserialize(change.serialize())


def test_capella_block_with_change_signature_sets(scheduled):
    cached, jcached = _capella_at(scheduled)
    changes = [tc.signed_change(cached.config, cached, v, bytes([v]) * 20) for v in (5, 9, 12)]
    signed = tc.produce_block(cached.config, cached, 2 * SPE + 1, changes=changes)
    pre, jpre = cached.copy(), tc.jax_cached(scheduled[2], cached)
    process_slots(pre, get_types(MINIMAL).capella, 2 * SPE + 1)
    j_process_slots(jpre, jget_types(JMINIMAL).capella, 2 * SPE + 1)
    sets = get_block_signature_sets(pre, get_types(MINIMAL).capella, signed)
    jsets = j_block_sets(jpre, jget_types(JMINIMAL).capella, tc.to_jax(signed))
    # proposer, randao and the three credential changes
    assert len(sets) == 5 and triples(sets) == triples(jsets)
    assert CpuBlsVerifier().verify_signature_sets(sets)
    apply_both(cached, jcached, signed)
    for v in (5, 9, 12):
        assert bytes(cached.state.validators[v].withdrawal_credentials)[12:] == bytes([v]) * 20


def test_capella_finality_and_a_historical_summaries_boundary(scheduled):
    """Empty blocks across both fork boundaries to epoch 3, every root
    compared; then empty slots to the first historical-summaries boundary
    (64 slots on minimal) and past it."""
    cached, jcached = both(scheduled)
    for slot in range(1, 3 * SPE + 1):
        apply_both(cached, jcached, tc.produce_block(cached.config, cached, slot))
    assert cached.fork == ForkName.capella and cached.state.slot == 3 * SPE
    boundary = MINIMAL.SLOTS_PER_HISTORICAL_ROOT
    for slot in (boundary - 1, boundary, boundary + 1):
        process_slots(cached, get_types(MINIMAL).capella, slot)
        j_process_slots(jcached, jget_types(JMINIMAL).capella, slot)
        assert cached.hash_tree_root() == jcached.hash_tree_root(), slot
        assert len(cached.state.historical_summaries) == int(slot >= boundary)
    assert len(cached.state.historical_roots) == 0
    cached.sync_flat()
    jcached.sync_flat()
    assert cached.state.serialize() == jcached.state.serialize()


def test_weak_subjectivity_on_several_states(scheduled):
    cached, jcached = _capella_at(scheduled)
    rng = np.random.default_rng(SEED)
    states = [(cached, jcached)]
    for low in (16, 31, 32):
        c = cached.copy()
        c.flat.effective_balance[:] = np.uint64(low * 10**9)
        c.flat.balances[:] = np.uint64(low * 10**9) + rng.integers(0, 10**9, len(c.flat)).astype(
            np.uint64)
        c.sync_flat()
        c.reload_state(c.state)
        states.append((c, tc.jax_cached(scheduled[2], c)))
    for c, jc in states:
        period = ws.compute_weak_subjectivity_period(c)
        assert period == jws.compute_weak_subjectivity_period(jc)
        for epoch in (0, c.current_epoch, c.current_epoch - period, c.current_epoch - period - 1):
            assert ws.is_within_weak_subjectivity_period(c, epoch) \
                == jws.is_within_weak_subjectivity_period(jc, epoch)


@pytest.mark.parametrize("fork", ["bellatrix", "capella"])
def test_ssz_carry_round_trips_bellatrix_and_capella(scheduled, fork):
    cached, _ = both(scheduled)
    slot = SPE + 1 if fork == "bellatrix" else 2 * SPE + 1
    process_slots(cached, get_types(MINIMAL).altair, slot - 1)
    changes = ([tc.signed_change(cached.config, cached, 2, b"\x02" * 20)]
               if fork == "capella" else ())
    signed = tc.produce_block(cached.config, cached, slot, changes=changes)
    state_transition(cached, get_types(MINIMAL).by_fork[fork], signed)
    cached.sync_flat()
    t = get_types(MINIMAL).by_fork[fork]
    for value, port_type in ((cached.state, t.BeaconState), (signed, t.SignedBeaconBlock)):
        theirs = tc.to_jax(value)
        assert theirs.hash_tree_root() == value.hash_tree_root()
        assert ssz_from_jax(theirs, port_type).serialize() == value.serialize()
