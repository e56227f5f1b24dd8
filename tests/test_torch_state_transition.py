"""The port's state transition (`lodestar_tpu_torch.state_transition`)
against the JAX package's, byte for byte, on the minimal preset with
Altair at epoch 1 (helpers in `torch_chain.py`): interop deposits and
their proofs, genesis roots, the post-state root after each block of a
chain that crosses the epoch-0 processing, the Altair upgrade, Altair
blocks with full sync aggregates and the epoch-1 processing, epoch
processing alone, a block of deposits (a new validator, a top-up, an
invalid signature), and the SSZ carry between the packages. JAX runs with
`verify_signatures=False` (its oracle would take minutes); the port's
inline checks on the C host tier are held to `lodestar_tpu.native`'s
verdicts on the same sets. Tolerance: bytes equal."""

import numpy as np
import pytest
import torch_chain

from lodestar_tpu import native as jnative
from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import state_transition as j_state_transition
from lodestar_tpu.state_transition.altair import process_epoch_altair as j_epoch_altair
from lodestar_tpu.state_transition.epoch import process_epoch as j_process_epoch
from lodestar_tpu.state_transition.genesis import make_interop_deposits as j_deposits
from lodestar_tpu.state_transition.signature_sets import (
    get_block_signature_sets as j_block_sets,
)
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.config.beacon_config import ChainForkConfig
from lodestar_tpu_torch.convert import ssz_from_jax, ssz_to_jax
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import process_slots, state_transition
from lodestar_tpu_torch.state_transition.altair import process_epoch_altair
from lodestar_tpu_torch.state_transition.block import BlockProcessingError
from lodestar_tpu_torch.state_transition.epoch import process_epoch
from lodestar_tpu_torch.state_transition.genesis import DepositTree, make_interop_deposits
from lodestar_tpu_torch.state_transition.stf import fork_types
from lodestar_tpu_torch.types import get_types


@pytest.fixture(scope="module")
def chain():
    return torch_chain.port_chain()


@pytest.fixture(scope="module")
def jax_side():
    return torch_chain.jax_genesis()


@pytest.mark.parametrize("n", [1, 2, 3, 16, 64])
def test_interop_deposits_and_proofs_are_the_jax_bytes(n):
    ours = make_interop_deposits(ChainForkConfig(torch_chain.port_chain_config(), MINIMAL),
                                 get_types(MINIMAL).phase0, n)
    theirs = j_deposits(JChainForkConfig(torch_chain.jax_chain_config(), JMINIMAL),
                        jget_types(JMINIMAL).phase0, n)
    assert [d.serialize() for d in ours] == [d.serialize() for d in theirs]


def test_deposit_tree_root_and_last_proof():
    from lodestar_tpu.state_transition.genesis import DepositTree as JDepositTree

    rng = np.random.default_rng(16)
    ours, theirs = DepositTree(), JDepositTree()
    for i in range(70):
        leaf = rng.bytes(32)
        ours.append(leaf)
        theirs.append(leaf)
        assert ours.root() == theirs.root()
        assert ours.last_proof() == theirs.proof(i)


def test_genesis_roots_equal(chain, jax_side):
    _, jcached = jax_side
    assert chain.genesis.state.serialize() == jcached.state.serialize()
    assert chain.genesis.hash_tree_root() == jcached.hash_tree_root()
    assert bytes(chain.genesis.state.genesis_validators_root) == bytes(
        jcached.state.genesis_validators_root)


def test_post_state_roots_equal_block_by_block(chain, jax_side):
    """Each block through the JAX transition from the JAX genesis: its
    post-state root the port's (and the block's own state root)."""
    _, jcached = jax_side
    jstate = jcached.copy()
    for signed, post in zip(chain.blocks, chain.posts):
        jblock = torch_chain.to_jax(signed, "SignedBeaconBlock")
        j_state_transition(jstate, None, jblock, verify_state_root=True,
                           verify_signatures=False)
        assert jstate.hash_tree_root() == post.hash_tree_root() == bytes(
            signed.message.state_root)
        assert jstate.state.serialize() == post.state.serialize()
    assert jstate.fork == "altair" and jstate.current_epoch == 2


def test_inline_checks_are_the_jax_native_verdicts(chain):
    """With `verify_signatures=True` the port's transition accepts every
    block (its inline checks on the C host tier), as `lodestar_tpu.native`
    accepts every set the JAX producer makes; the copy of the Altair block
    with two aggregates' signatures swapped is refused by both."""
    state = chain.genesis
    for signed in chain.blocks[:4]:
        pre = chain.factory.advance(state, signed.message.slot)
        jpre = torch_chain.jax_cached(_jconfig(chain), pre)
        jsets = j_block_sets(jpre, _jtypes(signed), torch_chain.to_jax(signed, "SignedBeaconBlock"))
        assert all(_jax_native(jsets))
        state = pre.copy()
        state_transition(state, fork_types(state), signed, verify_state_root=True,
                         verify_signatures=True)
    pre = chain.factory.advance(chain.posts[2], 9)
    bad = chain.factory.swapped(pre, chain.blocks[3], 1, 3)
    jpre = torch_chain.jax_cached(_jconfig(chain), pre)
    verdicts = _jax_native(j_block_sets(jpre, _jtypes(bad), torch_chain.to_jax(
        bad, "SignedBeaconBlock")))
    assert [k for k, ok in enumerate(verdicts) if not ok] == [3, 5]
    with pytest.raises(BlockProcessingError, match="bad attestation signature"):
        state_transition(pre, fork_types(pre), bad, verify_state_root=True,
                         verify_signatures=True)


def _jconfig(chain):
    from lodestar_tpu.config.beacon_config import BeaconConfig

    return BeaconConfig(torch_chain.jax_chain_config(),
                        bytes(chain.genesis.state.genesis_validators_root), JMINIMAL)


def _jtypes(value):
    return jget_types(JMINIMAL).by_fork[torch_chain.fork_of(value)]


def _jax_native(sets):
    return jnative.bls_verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(bytes(s.signature) for s in sets), DST_G2)


@pytest.mark.parametrize("at", ["phase0", "altair"])
def test_epoch_processing_alone(chain, at):
    """`process_epoch` (phase0, after blocks 1-3) and `process_epoch_altair`
    (after blocks 9 and 10) on the last slot of the epoch, against the JAX
    functions on the same state."""
    parent, last = (chain.posts[2], 7) if at == "phase0" else (chain.posts[4], 15)
    ours = chain.factory.advance(parent, last)
    theirs = torch_chain.jax_cached(_jconfig(chain), ours)
    jtypes = jget_types(JMINIMAL).by_fork[at]
    if at == "phase0":
        process_epoch(ours, fork_types(ours))
        j_process_epoch(theirs, jtypes)
    else:
        process_epoch_altair(ours, fork_types(ours))
        j_epoch_altair(theirs, jtypes)
    ours.sync_flat()
    theirs.sync_flat()
    assert ours.state.serialize() == theirs.state.serialize()
    assert ours.hash_tree_root() == theirs.hash_tree_root()


def _deposit_block(chain, with_invalid: bool):
    """(genesis whose eth1 data announces the deposits, the signed block
    at slot 1 that carries them, its port post-state): a new validator, a
    top-up of validator 3 and, `with_invalid`, a new key whose signature
    is another message's."""
    n = torch_chain.N
    p0 = get_types(MINIMAL).phase0
    fresh = make_interop_deposits(chain.config, p0, n + 2)
    top_up = p0.DepositData(pubkey=bytes(chain.genesis.state.validators[3].pubkey),
                            withdrawal_credentials=b"\x00" * 32, amount=10**9,
                            signature=bytes(fresh[n].data.signature))
    datas = [d.data for d in fresh[:n + 1]] + [top_up]
    if with_invalid:
        invalid = fresh[n + 1].data.copy()
        invalid.signature = bytes(fresh[n].data.signature)
        datas.append(invalid)
    tree = DepositTree()
    for d in datas:
        tree.append(d.hash_tree_root())
    # each proof against the root of all the leaves
    deposits = [p0.Deposit(proof=_proof(datas, i), data=datas[i])
                for i in range(n, len(datas))]
    genesis = chain.genesis.copy()
    genesis.state.eth1_data = p0.Eth1Data(deposit_root=tree.root(), deposit_count=len(datas),
                                          block_hash=b"\x42" * 32)
    pre = chain.factory.advance(genesis, 1)
    block = p0.BeaconBlock(
        slot=1, proposer_index=pre.epoch_ctx.get_beacon_proposer(1),
        parent_root=pre.state.latest_block_header.hash_tree_root(), state_root=b"\x00" * 32,
        body=p0.BeaconBlockBody(randao_reveal=chain.blocks[0].message.body.randao_reveal,
                                eth1_data=pre.state.eth1_data.copy(), deposits=deposits))
    signed, post = chain.factory.seal(pre, block)
    assert len(post.state.validators) == n + 1
    assert post.state.balances[3] == MINIMAL.MAX_EFFECTIVE_BALANCE + 10**9
    assert post.epoch_ctx.pubkey_to_index[bytes(datas[n].pubkey)] == n
    assert post.state.eth1_deposit_index == len(datas)
    return genesis, signed, post


def test_deposits_in_a_block(chain):
    """A block with a new validator's deposit and a top-up: the JAX
    transition's post-state, and the new key in the port's epoch
    context."""
    genesis, signed, post = _deposit_block(chain, with_invalid=False)
    jpre = torch_chain.jax_cached(_jconfig(chain), genesis)
    j_state_transition(jpre, None, torch_chain.to_jax(signed, "SignedBeaconBlock"),
                       verify_state_root=True, verify_signatures=False)
    assert jpre.state.serialize() == post.state.serialize()


def test_a_deposit_with_an_invalid_signature_is_skipped(chain):
    """A new key whose deposit signature does not verify is skipped, not
    failed (spec `apply_deposit`): the port's post-state has no validator
    for it and the deposit index past it. (The JAX package's
    `process_deposit` then looks the key up as a top-up and raises
    KeyError; the port does not.)"""
    genesis, signed, post = _deposit_block(chain, with_invalid=True)
    assert post.state.serialize() != genesis.state.serialize()
    jpre = torch_chain.jax_cached(_jconfig(chain), genesis)
    with pytest.raises(KeyError):
        j_state_transition(jpre, None, torch_chain.to_jax(signed, "SignedBeaconBlock"),
                           verify_state_root=False, verify_signatures=False)


def _proof(datas, index):
    from lodestar_tpu.state_transition.genesis import DepositTree as JDepositTree

    t = JDepositTree()
    for d in datas:
        t.append(d.hash_tree_root())
    return t.proof(index)


def test_ssz_carry_round_trips_phase0_and_altair_states(chain):
    for post in (chain.posts[2], chain.posts[4]):
        post.sync_flat()
        fork = torch_chain.fork_of(post.state)
        jstate = ssz_to_jax(post.state, jget_types(JMINIMAL).by_fork[fork].BeaconState)
        back = ssz_from_jax(jstate, get_types(MINIMAL).by_fork[fork].BeaconState)
        assert jstate.hash_tree_root() == post.state.hash_tree_root()
        assert back.serialize() == post.state.serialize()
        jblock = torch_chain.to_jax(chain.blocks[4], "SignedBeaconBlock")
        assert ssz_from_jax(jblock, get_types(MINIMAL).altair.SignedBeaconBlock).serialize() \
            == chain.blocks[4].serialize()


def test_a_scheduled_bellatrix_upgrade_is_refused():
    """Named for the port's former refusal of a scheduled Bellatrix upgrade:
    Altair and Bellatrix both scheduled at epoch 1 now upgrade in turn at
    the boundary, to the JAX package's state root."""
    from lodestar_tpu.state_transition import process_slots as j_process_slots
    from lodestar_tpu_torch import profile_block
    from lodestar_tpu_torch.state_transition import CachedBeaconState

    n, spe = 16, MINIMAL.SLOTS_PER_EPOCH
    cc = torch_chain.port_chain_config(BELLATRIX_FORK_EPOCH=1)
    config, genesis, _ = profile_block.interop_chain(cc, MINIMAL, n)
    _, jcached = torch_chain.jax_genesis(n, torch_chain.jax_chain_config(BELLATRIX_FORK_EPOCH=1))
    cached = CachedBeaconState(config, genesis.state.copy(), MINIMAL)
    assert cached.hash_tree_root() == jcached.hash_tree_root()
    for slot in (spe, spe + 1):
        process_slots(cached, fork_types(cached), slot)
        j_process_slots(jcached, jget_types(JMINIMAL).by_fork[jcached.fork], slot)
        assert cached.fork == jcached.fork == "bellatrix"
        assert cached.hash_tree_root() == jcached.hash_tree_root(), slot
    assert bytes(cached.state.fork.current_version) == bytes(cc.BELLATRIX_FORK_VERSION)
