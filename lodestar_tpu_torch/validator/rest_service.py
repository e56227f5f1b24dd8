"""Validator client over the REST Beacon API (the port's copy of the JAX
package's `validator/rest_service.py`, over the port's `BeaconApiClient`).

Reference: `validator/src/validator.ts:53` + `services/` — the production
validator never touches chain internals; it discovers duties, produces and
publishes everything through the Beacon API, gated by slashing protection
and doppelganger checks. This mirrors that wiring over `BeaconApiClient`.
"""

from __future__ import annotations

from ..utils.logger import get_logger
from .doppelganger import DoppelgangerService
from .store import ValidatorStore


class RestValidatorService:
    def __init__(
        self,
        config,
        types,
        client,
        store: ValidatorStore,
        doppelganger: DoppelgangerService | None = None,
        fee_recipient: bytes | None = None,
    ):
        self.config = config
        self.types = types
        self.client = client
        self.store = store
        self.doppelganger = doppelganger
        self.fee_recipient = fee_recipient
        self.log = get_logger("validator")
        self._indices: dict[bytes, int] = {}  # pubkey → validator index
        self._attester_duties: dict[int, list[dict]] = {}  # slot → duties
        self._proposer_duties: dict[int, int] = {}  # slot → validator index
        self._duties_epoch = -1

    # -- index + duty discovery ----------------------------------------------

    def resolve_indices(self) -> dict[bytes, int]:
        unresolved = [pk for pk in self.store.pubkeys if pk not in self._indices]
        for pk in unresolved:
            try:
                entry = self.client.getStateValidator("head", "0x" + pk.hex())
            except Exception as e:
                # unresolved keys retry on the next duty poll
                self.log.debug(
                    "getStateValidator(%s…) failed: %s", pk.hex()[:8], e
                )
                continue
            if entry is not None:
                self._indices[pk] = int(entry["index"])
        return self._indices

    def update_duties(self, epoch: int) -> None:
        """Refresh attester + proposer duty maps for `epoch` (reference
        attestationDutiesService/blockDutiesService polling)."""
        indices = self.resolve_indices()
        if not indices:
            return
        if self.doppelganger is not None:
            # late-resolving indices still get the full observation window
            # (register() is idempotent — no effect on known indices)
            for idx in indices.values():
                self.doppelganger.register(idx, epoch)
        self._attester_duties.clear()
        self._proposer_duties.clear()
        atts = self.client.getAttesterDuties(
            epoch, body=[str(i) for i in indices.values()]
        ) or []
        for duty in atts:
            self._attester_duties.setdefault(int(duty["slot"]), []).append(duty)
        props = self.client.getProposerDuties(epoch) or []
        ours = set(indices.values())
        for duty in props:
            if int(duty["validator_index"]) in ours:
                self._proposer_duties[int(duty["slot"])] = int(duty["validator_index"])
        self._duties_epoch = epoch
        if self.fee_recipient is not None:
            # re-register every epoch: the node-side proposer cache expires
            # stale registrations (reference prepareBeaconProposerService)
            try:
                self.client.prepareBeaconProposer(
                    body=[
                        {
                            "validator_index": str(i),
                            "fee_recipient": "0x" + self.fee_recipient.hex(),
                        }
                        for i in indices.values()
                    ]
                )
            except Exception as e:
                self.log.warning("prepareBeaconProposer failed: %s", e)
        self.log.info(
            "duties epoch %d: %d attester slots, %d proposals",
            epoch,
            len(self._attester_duties),
            len(self._proposer_duties),
        )

    def _pubkey_of(self, index: int) -> bytes | None:
        for pk, idx in self._indices.items():
            if idx == index:
                return pk
        return None

    def _may_sign(self, index: int) -> bool:
        return self.doppelganger is None or self.doppelganger.is_signing_safe(index)

    # -- per-slot work --------------------------------------------------------

    def on_slot(self, slot: int) -> None:
        spe = self.config.preset.SLOTS_PER_EPOCH
        epoch = slot // spe
        if epoch != self._duties_epoch:
            self.update_duties(epoch)
            if self.doppelganger is not None and epoch > 0:
                liveness = self.client.getLiveness(
                    epoch - 1, body=[str(i) for i in self._indices.values()]
                ) or []
                self.doppelganger.on_epoch(
                    epoch, {int(e["index"]): e["is_live"] for e in liveness}
                )
        self.propose_if_due(slot)
        self.attest_if_due(slot)

    def propose_if_due(self, slot: int):
        index = self._proposer_duties.get(slot)
        if index is None:
            return None
        pk = self._pubkey_of(index)
        if pk is None or not self._may_sign(index):
            return None
        reveal = self.store.sign_randao(pk, slot)
        obj = self.client.produceBlockV2(
            slot, query={"randao_reveal": "0x" + reveal.hex()}
        )
        from ..types import get_types

        types = get_types(self.config.preset).by_fork.get(
            obj.get("version"), self.types
        )
        block = types.BeaconBlock.from_obj(obj["data"])
        signed = self.store.sign_block(pk, types, block)
        self.client.publishBlock(body=signed.to_obj())
        self.log.info("proposed block at slot %d (validator %d)", slot, index)
        return signed

    def attest_if_due(self, slot: int) -> list:
        duties = self._attester_duties.get(slot, [])
        produced = []
        for duty in duties:
            index = int(duty["validator_index"])
            pk = self._pubkey_of(index)
            if pk is None or not self._may_sign(index):
                continue
            cidx = int(duty["committee_index"])
            data_obj = self.client.produceAttestationData(
                query={"slot": slot, "committee_index": cidx}
            )
            data = self.types.AttestationData.from_obj(data_obj)
            sig = self.store.sign_attestation(pk, data)
            bits = [False] * int(duty["committee_length"])
            bits[int(duty["validator_committee_index"])] = True
            att = self.types.Attestation(
                aggregation_bits=bits, data=data, signature=sig
            )
            self.client.submitPoolAttestations(body=[att.to_obj()])
            produced.append(att)
            # aggregation duty (reference: aggregator per committee)
            if self.store.is_aggregator(slot, len(bits), pk):
                self._aggregate(slot, cidx, pk, index, data)
        return produced

    def _aggregate(self, slot: int, cidx: int, pk: bytes, index: int, data) -> None:
        try:
            agg_obj = self.client.getAggregatedAttestation(
                query={
                    "slot": slot,
                    "attestation_data_root": "0x" + data.hash_tree_root().hex(),
                }
            )
        except Exception:
            return
        aggregate = self.types.Attestation.from_obj(agg_obj)
        proof = self.store.sign_selection_proof(pk, slot)
        agg_and_proof = self.types.AggregateAndProof(
            aggregator_index=index, aggregate=aggregate, selection_proof=proof
        )
        signed = self.store.sign_aggregate_and_proof(pk, self.types, agg_and_proof)
        self.client.publishAggregateAndProofs(body=[signed.to_obj()])
