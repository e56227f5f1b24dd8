"""BeaconConfig = chain config + fork schedule + cached signing domains.

Equivalent of packages/config/src/beaconConfig.ts
(`createIBeaconConfig`): binds a ChainConfig + preset to a
``genesis_validators_root`` and precomputes the signing domain for every
(fork, domain_type) pair, since domain computation involves hashing
(`getDomain`, config/src/forkConfig + domain cache).
"""

from __future__ import annotations

from hashlib import sha256

from ..params import ACTIVE_PRESET, PRESETS, Preset
from .chain_config import ChainConfig, NETWORK_CONFIGS
from .fork_config import ForkConfig


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    """hash_tree_root(ForkData(current_version, genesis_validators_root)).

    ForkData is a 2-field container of (Bytes4, Bytes32): its root is the hash
    of the two 32-byte chunks (version right-padded).
    """
    chunk0 = current_version + b"\x00" * 28
    return sha256(chunk0 + genesis_validators_root).digest()


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: bytes,
    genesis_validators_root: bytes,
) -> bytes:
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fork_data_root[:28]


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    """hash_tree_root(SigningData(object_root, domain)) — the message actually
    signed by every BLS signature in the protocol."""
    return sha256(object_root + domain).digest()


class ChainForkConfig(ForkConfig):
    """ChainConfig + preset + fork schedule (reference `IChainForkConfig`)."""

    def __init__(self, chain_config: ChainConfig, preset: Preset | None = None):
        self.chain = chain_config
        self.preset = preset or PRESETS.get(chain_config.PRESET_BASE, ACTIVE_PRESET)
        super().__init__(chain_config, self.preset.SLOTS_PER_EPOCH)

    def __getattr__(self, name: str):
        # Fall through to chain config then preset, so spec code can write
        # `config.SLOTS_PER_EPOCH` or `config.SECONDS_PER_SLOT` uniformly.
        chain = object.__getattribute__(self, "chain")
        if hasattr(chain, name):
            return getattr(chain, name)
        preset = object.__getattribute__(self, "preset")
        if hasattr(preset, name):
            return getattr(preset, name)
        raise AttributeError(name)


class BeaconConfig(ChainForkConfig):
    """ChainForkConfig bound to genesis_validators_root with a domain cache."""

    def __init__(
        self,
        chain_config: ChainConfig,
        genesis_validators_root: bytes,
        preset: Preset | None = None,
    ):
        super().__init__(chain_config, preset)
        self.genesis_validators_root = genesis_validators_root
        # (fork_version, domain_type) -> domain
        self._domain_cache: dict[tuple[bytes, bytes], bytes] = {}
        self._fork_digests: dict[str, bytes] = {
            f.name: compute_fork_digest(f.version, genesis_validators_root)
            for f in self.forks.values()
        }
        self._digest_to_fork = {d: n for n, d in self._fork_digests.items()}

    def get_domain(self, domain_type: bytes, slot: int, message_epoch: int | None = None) -> bytes:
        """Domain for signing at `slot` (spec `get_domain`): the fork version
        is taken from the epoch of the message (attestation epochs may differ
        from the state slot's epoch)."""
        epoch = message_epoch if message_epoch is not None else slot // self.slots_per_epoch
        fork_version = self.get_fork_version_at_epoch(epoch)
        return self.get_domain_at_fork(domain_type, fork_version)

    def get_domain_at_fork(self, domain_type: bytes, fork_version: bytes) -> bytes:
        key = (fork_version, domain_type)
        domain = self._domain_cache.get(key)
        if domain is None:
            domain = compute_domain(domain_type, fork_version, self.genesis_validators_root)
            self._domain_cache[key] = domain
        return domain

    def fork_digest(self, fork_name: str) -> bytes:
        return self._fork_digests[fork_name]

    def fork_name_from_digest(self, digest: bytes) -> str:
        return self._digest_to_fork[digest]


def create_chain_fork_config(chain_config: ChainConfig) -> ChainForkConfig:
    return ChainForkConfig(chain_config)


def create_beacon_config(
    chain_config: ChainConfig, genesis_validators_root: bytes
) -> BeaconConfig:
    return BeaconConfig(chain_config, genesis_validators_root)


def get_network_config(name: str) -> ChainForkConfig:
    return ChainForkConfig(NETWORK_CONFIGS[name])
