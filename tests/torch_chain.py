"""A small interop chain made by the port's `profile_block.BlockFactory`
on the minimal preset (Altair at epoch 1), and the JAX package's twin of
its genesis: the shared helpers of the port's state-transition,
signature-set and block-import tests.

`port_chain()` holds full-participation blocks at slots 1, 2, 3 (phase0,
each with the previous slot's aggregates), 9 (the first Altair block,
after the epoch-0 processing and the upgrade: an aggregate per committee
of slots 1..8 and a full sync aggregate), 10 and 17 (Altair, across the
epoch-1 processing), with each block's post-state.
"""

from dataclasses import dataclass, field

from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import CachedBeaconState as JCached
from lodestar_tpu.state_transition import interop_genesis_state as j_interop_genesis
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch import profile_block
from lodestar_tpu_torch.config.chain_config import MINIMAL_CHAIN_CONFIG
from lodestar_tpu_torch.convert import ssz_to_jax
from lodestar_tpu_torch.params.presets import MINIMAL

N = 64
# (slot, attestation slots, sync aggregate)
PLAN = [(1, [0], False), (2, [1], False), (3, [2], False), (9, range(1, 9), True),
        (10, [9], True), (17, range(10, 17), True)]


def port_chain_config(**overrides):
    return MINIMAL_CHAIN_CONFIG.with_overrides(ALTAIR_FORK_EPOCH=1, **overrides)


def jax_chain_config(**overrides):
    return J_MINIMAL_CC.with_overrides(ALTAIR_FORK_EPOCH=1, **overrides)


@dataclass
class Chain:
    config: object
    genesis: object
    factory: object
    blocks: list = field(default_factory=list)
    posts: list = field(default_factory=list)


def port_chain(n: int = N, plan=PLAN, threads: int = 2) -> Chain:
    config, genesis, _ = profile_block.interop_chain(port_chain_config(), MINIMAL, n)
    chain = Chain(config, genesis, profile_block.BlockFactory(config, n, threads))
    state = genesis
    for slot, att_slots, sync in plan:
        pre = chain.factory.advance(state, slot)
        signed, state = chain.factory.block(pre, chain.factory.attestations(pre, att_slots), sync)
        chain.blocks.append(signed)
        chain.posts.append(state)
    return chain


def jax_genesis(n: int = N, chain_config=None):
    """(JAX BeaconConfig, JAX CachedBeaconState) of the same genesis
    (`chain_config`: a JAX chain config, `jax_chain_config()` when not
    given)."""
    t = jget_types(JMINIMAL)
    chain_config = chain_config or jax_chain_config()
    state = j_interop_genesis(JChainForkConfig(chain_config, JMINIMAL), t.phase0, n,
                              genesis_time=profile_block.GENESIS_TIME)
    config = JBeaconConfig(chain_config, bytes(state.genesis_validators_root), JMINIMAL)
    return config, JCached(config, state, JMINIMAL)


def fork_of(value) -> str:
    """'altair' or 'phase0', by the shape of a state or a signed block."""
    body = getattr(getattr(value, "message", None), "body", None)
    if body is not None:
        return "altair" if hasattr(body, "sync_aggregate") else "phase0"
    return "altair" if hasattr(value, "previous_epoch_participation") else "phase0"


def to_jax(value, kind: str):
    """A port block or state → the JAX package's (`kind`: the class name,
    e.g. 'SignedBeaconBlock' or 'BeaconState')."""
    return ssz_to_jax(value, getattr(jget_types(JMINIMAL).by_fork[fork_of(value)], kind))


def jax_cached(jconfig, port_cached):
    """The JAX CachedBeaconState of a port CachedBeaconState's state."""
    port_cached.sync_flat()
    return JCached(jconfig, to_jax(port_cached.state, "BeaconState"), JMINIMAL)
