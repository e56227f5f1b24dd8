"""Shared helpers of the port's Bellatrix and Capella tests: the same
interop genesis on the minimal preset in both packages, under a schedule
(Altair at 0, Bellatrix at 1, Capella at 2) or with every fork at
genesis and the merge complete (the JAX `tests/test_execution_chain.py`
fixture), and blocks made and signed by the port (interop keys on the C
host tier), carried to the JAX package through their SSZ bytes.
"""

from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import CachedBeaconState as JCached
from lodestar_tpu.state_transition import interop_genesis_state as j_interop_genesis
from lodestar_tpu.state_transition.altair import upgrade_state_to_altair as j_to_altair
from lodestar_tpu.state_transition.bellatrix import upgrade_state_to_bellatrix as j_to_bellatrix
from lodestar_tpu.state_transition.capella import upgrade_state_to_capella as j_to_capella
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.bls import api as bls
from lodestar_tpu_torch.config.beacon_config import BeaconConfig, ChainForkConfig
from lodestar_tpu_torch.config.beacon_config import compute_signing_root
from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
from lodestar_tpu_torch.convert import ssz_to_jax
from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    ETH1_ADDRESS_WITHDRAWAL_PREFIX,
)
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.state_transition import (
    CachedBeaconState,
    interop_genesis_state,
    process_slots,
    state_transition,
)
from lodestar_tpu_torch.state_transition.altair import upgrade_state_to_altair
from lodestar_tpu_torch.state_transition.bellatrix import upgrade_state_to_bellatrix
from lodestar_tpu_torch.state_transition.block import _epoch_signing_root
from lodestar_tpu_torch.state_transition.capella import (
    bls_to_execution_change_signing_root,
    upgrade_state_to_capella,
)
from lodestar_tpu_torch.types import get_types

N = 16
SPE = MINIMAL.SLOTS_PER_EPOCH
GENESIS_TIME = 1_600_000_000
EL_GENESIS_HASH = b"\x01" * 32
SCHEDULE = dict(ALTAIR_FORK_EPOCH=0, BELLATRIX_FORK_EPOCH=1, CAPELLA_FORK_EPOCH=2)
AT_GENESIS = dict(ALTAIR_FORK_EPOCH=0, BELLATRIX_FORK_EPOCH=0, CAPELLA_FORK_EPOCH=0)


def sk(i):
    return bls.interop_secret_key(i)


def eth1_credential(address: bytes) -> bytes:
    return ETH1_ADDRESS_WITHDRAWAL_PREFIX + b"\x00" * 11 + address


def altair_pair(n: int = N, schedule=SCHEDULE):
    """(port BeaconConfig, port Altair genesis state, JAX BeaconConfig, JAX
    Altair genesis state), each package's own interop genesis upgraded at
    slot 0."""
    cc = MINIMAL_CHAIN_CONFIG.with_overrides(**schedule)
    jcc = J_MINIMAL_CC.with_overrides(**schedule)
    t, jt = get_types(MINIMAL), jget_types(JMINIMAL)
    pre = interop_genesis_state(ChainForkConfig(cc, MINIMAL), t.phase0, n,
                                genesis_time=GENESIS_TIME)
    jpre = j_interop_genesis(JChainForkConfig(jcc, JMINIMAL), jt.phase0, n,
                             genesis_time=GENESIS_TIME)
    config = BeaconConfig(cc, bytes(pre.genesis_validators_root), MINIMAL)
    jconfig = JBeaconConfig(jcc, bytes(jpre.genesis_validators_root), JMINIMAL)
    return (config, upgrade_state_to_altair(config, MINIMAL, pre, t.altair),
            jconfig, j_to_altair(jconfig, JMINIMAL, jpre, jt.altair))


def capella_pair(n: int = N, withdrawing=(0,)):
    """`altair_pair` with every fork at genesis, upgraded to Bellatrix and
    Capella at slot 0 in each package, the payload header anchored at
    `EL_GENESIS_HASH` and the genesis time, and each validator of
    `withdrawing` given an eth1 credential (address 0xaa..) and an excess
    balance of 1,000,000 Gwei."""
    config, state, jconfig, jstate = altair_pair(n, AT_GENESIS)
    t, jt = get_types(MINIMAL), jget_types(JMINIMAL)
    state = upgrade_state_to_capella(
        config, MINIMAL, upgrade_state_to_bellatrix(config, MINIMAL, state, t.bellatrix),
        t.capella)
    jstate = j_to_capella(
        jconfig, JMINIMAL, j_to_bellatrix(jconfig, JMINIMAL, jstate, jt.bellatrix), jt.capella)
    for s in (state, jstate):
        s.latest_execution_payload_header.block_hash = EL_GENESIS_HASH
        s.latest_execution_payload_header.timestamp = s.genesis_time
        for v in withdrawing:
            s.validators[v].withdrawal_credentials = eth1_credential(b"\xaa" * 20)
            s.balances[v] = MINIMAL.MAX_EFFECTIVE_BALANCE + 1_000_000
    return config, state, jconfig, jstate


def jax_cached(jconfig, cached):
    """The JAX CachedBeaconState of a port CachedBeaconState's state."""
    cached.sync_flat()
    return JCached(jconfig, to_jax(cached.state), JMINIMAL)


def to_jax(value):
    """A port state or signed block of any fork → the JAX package's."""
    return ssz_to_jax(value, getattr(jget_types(JMINIMAL).by_fork[fork_of(value)],
                                     type(value).__name__))


def to_jax_payload(payload):
    """A port Capella ExecutionPayload → the JAX package's."""
    return jget_types(JMINIMAL).capella.ExecutionPayload.deserialize(payload.serialize())


def fork_of(value) -> str:
    """The fork of a state or a signed block, by its fields."""
    body = getattr(getattr(value, "message", None), "body", None)
    names = {name for name, _ in (body if body is not None else value).fields}
    for fork, field in (("capella", "bls_to_execution_changes" if body is not None
                         else "historical_summaries"),
                        ("bellatrix", "execution_payload" if body is not None
                         else "latest_execution_payload_header"),
                        ("altair", "sync_aggregate" if body is not None
                         else "current_sync_committee")):
        if field in names:
            return fork
    return "phase0"


def signed_change(config, cached, index: int, address: bytes, signer: int | None = None):
    """A port SignedBLSToExecutionChange moving `index` to `address`,
    signed by interop key `signer` (the validator's own by default: in the
    interop genesis the withdrawal key is the signing key)."""
    t = get_types(MINIMAL).capella
    change = t.BLSToExecutionChange(validator_index=index,
                                    from_bls_pubkey=sk(index).to_public_key().to_bytes(),
                                    to_execution_address=address)
    root = bls_to_execution_change_signing_root(config, cached.state, change)
    key = sk(index if signer is None else signer)
    return t.SignedBLSToExecutionChange(message=change, signature=key.sign(root).to_bytes())


def produce_block(config, cached, slot, payload=None, changes=(), deposits=()):
    """A valid port block at `slot` on `cached` (the JAX test's
    `_produce_block`): no attestations, an empty sync aggregate, an
    optional payload, credential changes and deposits, the state root
    from a trial transition, signed by the slot's proposer."""
    pre = cached.copy()
    if slot > pre.state.slot:
        process_slots(pre, get_types(MINIMAL).by_fork[pre.fork], slot)
    types = get_types(MINIMAL).by_fork[pre.fork]
    proposer = pre.epoch_ctx.get_beacon_proposer(slot)
    body = types.BeaconBlockBody(
        randao_reveal=sk(proposer).sign(
            _epoch_signing_root(slot // SPE, config.get_domain(DOMAIN_RANDAO, slot))).to_bytes(),
        eth1_data=pre.state.eth1_data.copy(), deposits=list(deposits))
    if hasattr(body, "sync_aggregate"):
        body.sync_aggregate = types.SyncAggregate(
            sync_committee_bits=[False] * MINIMAL.SYNC_COMMITTEE_SIZE,
            sync_committee_signature=b"\xc0" + b"\x00" * 95)
    if payload is not None:
        body.execution_payload = payload
    if changes:
        body.bls_to_execution_changes = list(changes)
    block = types.BeaconBlock(slot=slot, proposer_index=proposer,
                              parent_root=pre.state.latest_block_header.hash_tree_root(),
                              state_root=b"\x00" * 32, body=body)
    trial = pre.copy()
    state_transition(trial, types,
                     types.SignedBeaconBlock(message=block.copy(), signature=b"\x00" * 96),
                     verify_state_root=False, verify_signatures=False)
    block.state_root = trial.state.hash_tree_root()
    sig = sk(proposer).sign(compute_signing_root(
        block.hash_tree_root(), config.get_domain(DOMAIN_BEACON_PROPOSER, slot)))
    return types.SignedBeaconBlock(message=block, signature=sig.to_bytes())


def port_cached(config, state):
    return CachedBeaconState(config, state.copy(), MINIMAL)
