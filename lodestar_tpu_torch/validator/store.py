"""ValidatorStore: keys + slashing-gated signing (the port's copy of the JAX
package's `validator/store.py`, signing on the host tier through
`bls/api.py`).

Reference: `validator/src/services/validatorStore.ts` — signBlock (:307),
signAttestation (:358) with checkAndInsert* protection gates (:379),
randao reveals, selection proofs, aggregate-and-proof signing.
"""

from __future__ import annotations

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
)
from ..ssz import uint64
from ..state_transition import util as st_util
from .slashing_protection import SlashingProtection


class ValidatorStore:
    def __init__(self, config, slashing_protection: SlashingProtection):
        self.config = config
        self.protection = slashing_protection
        self._keys: dict[bytes, bls.SecretKey] = {}
        # pubkey → ExternalSignerClient (reference: remote signer support in
        # validatorStore via externalSignerClient)
        self._remote: dict[bytes, object] = {}

    # -- key management ------------------------------------------------------

    def add_secret_key(self, sk: bls.SecretKey) -> bytes:
        pk = sk.to_public_key().to_bytes()
        self._keys[pk] = sk
        return pk

    def add_remote_key(self, pubkey: bytes, signer) -> bytes:
        """Register a pubkey whose signatures come from an external signer
        (reference: `externalSignerClient`)."""
        self._remote[pubkey] = signer
        return pubkey

    def remove_key(self, pubkey: bytes) -> bool:
        # pop BOTH maps: a pubkey registered as local and remote must lose
        # every signing path, or a keymanager delete would report success
        # while the remote path keeps signing
        local = self._keys.pop(pubkey, None) is not None
        remote = self._remote.pop(pubkey, None) is not None
        return local or remote

    def has_pubkey(self, pubkey: bytes) -> bool:
        return pubkey in self._keys or pubkey in self._remote

    @property
    def pubkeys(self) -> list[bytes]:
        return list(dict.fromkeys(list(self._keys) + list(self._remote)))

    def _sign_root(self, pubkey: bytes, root: bytes) -> bytes:
        sk = self._keys.get(pubkey)
        if sk is not None:
            return sk.sign(root).to_bytes()
        signer = self._remote.get(pubkey)
        if signer is not None:
            return signer.sign(pubkey, root)
        raise KeyError(f"no signer for {pubkey.hex()}")

    # -- signing (each gate mirrors validatorStore) --------------------------

    def sign_block(self, pubkey: bytes, types, block):
        domain = self.config.get_domain(DOMAIN_BEACON_PROPOSER, block.slot)
        root = compute_signing_root(block.hash_tree_root(), domain)
        self.protection.check_and_insert_block_proposal(pubkey, block.slot, root)
        sig = self._sign_root(pubkey, root)
        return types.SignedBeaconBlock(message=block, signature=sig)

    def sign_attestation(self, pubkey: bytes, data) -> bytes:
        spe = self.config.preset.SLOTS_PER_EPOCH
        domain = self.config.get_domain(
            DOMAIN_BEACON_ATTESTER,
            st_util.compute_start_slot_at_epoch(data.target.epoch, spe),
            data.target.epoch,
        )
        root = compute_signing_root(data.hash_tree_root(), domain)
        self.protection.check_and_insert_attestation(
            pubkey, data.source.epoch, data.target.epoch, root
        )
        return self._sign_root(pubkey, root)

    def sign_randao(self, pubkey: bytes, slot: int) -> bytes:
        epoch = slot // self.config.preset.SLOTS_PER_EPOCH
        domain = self.config.get_domain(DOMAIN_RANDAO, slot)
        root = compute_signing_root(uint64.hash_tree_root(epoch), domain)
        return self._sign_root(pubkey, root)

    def sign_selection_proof(self, pubkey: bytes, slot: int) -> bytes:
        domain = self.config.get_domain(DOMAIN_SELECTION_PROOF, slot)
        root = compute_signing_root(uint64.hash_tree_root(slot), domain)
        return self._sign_root(pubkey, root)

    def sign_aggregate_and_proof(self, pubkey: bytes, types, agg_and_proof):
        domain = self.config.get_domain(
            DOMAIN_AGGREGATE_AND_PROOF, agg_and_proof.aggregate.data.slot
        )
        root = compute_signing_root(agg_and_proof.hash_tree_root(), domain)
        sig = self._sign_root(pubkey, root)
        return types.SignedAggregateAndProof(
            message=agg_and_proof, signature=sig
        )

    def is_aggregator(
        self, slot: int, committee_size: int, pubkey: bytes, proof: bytes | None = None
    ) -> bool:
        """TARGET_AGGREGATORS_PER_COMMITTEE-based selection (spec
        is_aggregator): hash(selection_proof) mod max(1, size/16) == 0."""
        from ..params import TARGET_AGGREGATORS_PER_COMMITTEE
        from ..ssz.hashing import sha256

        if proof is None:
            proof = self.sign_selection_proof(pubkey, slot)
        modulo = max(1, committee_size // TARGET_AGGREGATORS_PER_COMMITTEE)
        return int.from_bytes(sha256(proof)[:8], "little") % modulo == 0
