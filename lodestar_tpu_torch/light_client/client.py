"""Light client: trust-minimized chain following (the port's copy of the
JAX package's `light_client/client.py`).

Reference: `light-client/src/index.ts` (Lightclient) + `validation.ts`
(assertValidLightClientUpdate): bootstrap from a trusted block root,
then apply sync-committee-signed updates — verifying committee merkle
proofs, finality proofs and the aggregate BLS signature — tracking
optimistic and finalized headers with only headers + proofs.

The sync aggregate's signature is checked by `bls.api.fast_aggregate_verify`
on the C host tier: one key aggregate and one pairing check per update,
no device work, as in the JAX client.
"""

from __future__ import annotations

from ..bls import api as bls
from ..config.beacon_config import compute_signing_root
from ..params import (
    DOMAIN_SYNC_COMMITTEE,
    CURRENT_SYNC_COMMITTEE_DEPTH,
    CURRENT_SYNC_COMMITTEE_GINDEX,
    FINALIZED_ROOT_DEPTH,
    FINALIZED_ROOT_GINDEX,
    NEXT_SYNC_COMMITTEE_DEPTH,
    NEXT_SYNC_COMMITTEE_GINDEX,
)
from ..state_transition import util as st_util


class LightClientError(ValueError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise LightClientError(msg)


def _verify_branch(leaf: bytes, branch, gindex: int, depth: int, root: bytes) -> bool:
    return st_util.is_valid_merkle_branch(
        leaf, [bytes(b) for b in branch], depth, gindex % (1 << depth), root
    )


class Lightclient:
    def __init__(self, config, types, preset):
        self.config = config
        self.types = types
        self.preset = preset
        self.finalized_header = None
        self.optimistic_header = None
        self.current_sync_committee = None
        self.next_sync_committee = None

    # -- bootstrap -----------------------------------------------------------

    def bootstrap(self, trusted_block_root: bytes, bootstrap) -> None:
        header = bootstrap.header
        _require(
            header.hash_tree_root() == trusted_block_root,
            "bootstrap header != trusted root",
        )
        _require(
            _verify_branch(
                bootstrap.current_sync_committee.hash_tree_root(),
                bootstrap.current_sync_committee_branch,
                CURRENT_SYNC_COMMITTEE_GINDEX,
                CURRENT_SYNC_COMMITTEE_DEPTH,
                bytes(header.state_root),
            ),
            "invalid current sync committee proof",
        )
        self.finalized_header = header.copy()
        self.optimistic_header = header.copy()
        self.current_sync_committee = bootstrap.current_sync_committee.copy()

    # -- update processing ---------------------------------------------------

    def _period(self, slot: int) -> int:
        return slot // (
            self.preset.SLOTS_PER_EPOCH * self.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )

    def process_update(self, update) -> None:
        """assertValidLightClientUpdate + apply (simplified store: no
        best-valid-update/UPDATE_TIMEOUT machinery — updates are applied
        when finality-proven and supermajority-signed)."""
        _require(self.finalized_header is not None, "not bootstrapped")
        attested = update.attested_header
        _require(
            update.signature_slot > attested.slot,
            "signature slot not after attested slot",
        )
        _require(
            attested.slot >= self.finalized_header.slot,
            "update older than finalized header",
        )
        attested_period = self._period(attested.slot)
        store_period = self._period(self.finalized_header.slot)
        _require(
            attested_period in (store_period, store_period + 1),
            "update outside current/next period",
        )

        # next-sync-committee proof against the attested state
        _require(
            _verify_branch(
                update.next_sync_committee.hash_tree_root(),
                update.next_sync_committee_branch,
                NEXT_SYNC_COMMITTEE_GINDEX,
                NEXT_SYNC_COMMITTEE_DEPTH,
                bytes(attested.state_root),
            ),
            "invalid next sync committee proof",
        )
        # finality proof. Spec zero-case: before any finalization the
        # attested state's finalized root is ZERO — the update then carries
        # an empty header and the proof is verified against the zero leaf.
        has_finality = any(bytes(b) != b"\x00" * 32 for b in update.finality_branch)
        is_empty_header = (
            update.finalized_header == self.types.BeaconBlockHeader()
        )
        if has_finality:
            leaf = (
                b"\x00" * 32
                if is_empty_header
                else update.finalized_header.hash_tree_root()
            )
            _require(
                _verify_branch(
                    leaf,
                    update.finality_branch,
                    FINALIZED_ROOT_GINDEX,
                    FINALIZED_ROOT_DEPTH,
                    bytes(attested.state_root),
                ),
                "invalid finality proof",
            )
        has_finality = has_finality and not is_empty_header

        # sync-aggregate signature: signer committee is selected by the
        # SIGNATURE slot's period (spec validate_light_client_update) —
        # keying off the attested period stalls at every period boundary
        self._verify_sync_aggregate(
            attested, update.sync_aggregate, update.signature_slot
        )

        # apply (spec apply_light_client_update): committee rotation keys
        # off the FINALIZED period so store_period and the committees stay
        # consistent — rotating on the attested period desyncs the selector
        # and permanently stalls the client after the first cross-period
        # update
        update_finalized_period = (
            self._period(update.finalized_header.slot)
            if has_finality
            else store_period
        )
        if self.next_sync_committee is None:
            _require(
                update_finalized_period == store_period,
                "cannot learn next committee from a future-period update",
            )
            self.next_sync_committee = update.next_sync_committee.copy()
        elif update_finalized_period == store_period + 1:
            self.current_sync_committee = self.next_sync_committee
            self.next_sync_committee = update.next_sync_committee.copy()
        if attested.slot > self.optimistic_header.slot:
            self.optimistic_header = attested.copy()
        if has_finality and update.finalized_header.slot > self.finalized_header.slot:
            self.finalized_header = update.finalized_header.copy()

    def _committee_for_signature_slot(self, signature_slot: int):
        """Signer committee by the signature slot's period relative to the
        store (current period → current committee, next → next)."""
        _require(self.finalized_header is not None, "not bootstrapped")
        sig_period = self._period(signature_slot)
        store_period = self._period(self.finalized_header.slot)
        if sig_period == store_period:
            committee = self.current_sync_committee
        elif sig_period == store_period + 1:
            committee = self.next_sync_committee
        else:
            committee = None
        _require(committee is not None, "no committee for signature period")
        return committee

    def _verify_sync_aggregate(self, attested, aggregate, signature_slot: int):
        committee = self._committee_for_signature_slot(signature_slot)
        bits = list(aggregate.sync_committee_bits)
        participants = [bytes(pk) for pk, b in zip(committee.pubkeys, bits) if b]
        _require(
            3 * len(participants) >= 2 * len(bits), "insufficient participation"
        )
        previous_slot = max(signature_slot, 1) - 1
        domain = self.config.get_domain(
            DOMAIN_SYNC_COMMITTEE,
            previous_slot,
            st_util.compute_epoch_at_slot(previous_slot, self.preset.SLOTS_PER_EPOCH),
        )
        root = compute_signing_root(attested.hash_tree_root(), domain)
        pks = [bls.PublicKey.from_bytes(pk, validate=False) for pk in participants]
        sig = bls.Signature.from_bytes(
            bytes(aggregate.sync_committee_signature), validate=False
        )
        _require(bls.fast_aggregate_verify(pks, root, sig), "bad sync signature")

    def process_optimistic_update(self, update) -> None:
        """Header-only fast path (SSE optimistic updates)."""
        _require(self.finalized_header is not None, "not bootstrapped")
        attested = update.attested_header
        if self.optimistic_header is None or attested.slot > self.optimistic_header.slot:
            self._verify_sync_aggregate(
                attested, update.sync_aggregate, update.signature_slot
            )
            self.optimistic_header = attested.copy()

    def process_finality_update(self, update) -> None:
        """SSE finality updates: verified finality proof + aggregate
        advance the finalized header (reference processFinalizedUpdate)."""
        _require(self.finalized_header is not None, "not bootstrapped")
        finalized = update.finalized_header
        if finalized.slot <= self.finalized_header.slot:
            return  # stale
        _require(
            _verify_branch(
                finalized.hash_tree_root(),
                update.finality_branch,
                FINALIZED_ROOT_GINDEX,
                FINALIZED_ROOT_DEPTH,
                bytes(update.attested_header.state_root),
            ),
            "invalid finality proof",
        )
        self._verify_sync_aggregate(
            update.attested_header, update.sync_aggregate, update.signature_slot
        )
        self.finalized_header = finalized.copy()
        if (
            self.optimistic_header is None
            or update.attested_header.slot > self.optimistic_header.slot
        ):
            self.optimistic_header = update.attested_header.copy()
