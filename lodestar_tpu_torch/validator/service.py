"""Validator duty services: per-slot block proposal + attestation duties
(the port's copy of the JAX package's `validator/service.py`, over the
port's `BeaconChain`, whose block imports run their verdicts on the
serving stack's device).

Reference: `validator/src/services/` — `AttestationDutiesService` (epoch
duty discovery), `AttestationService` (produce/sign/publish at slot/3,
aggregate at 2·slot/3), `BlockProposingService`. The `api` parameter is
anything exposing the in-process beacon-api surface (`BeaconChain`;
`RestValidatorService` is the same duties over the Beacon API). Its
metrics are the node bundle's `vc_*` families (`metrics/beacon.py`)."""

from __future__ import annotations

from dataclasses import dataclass

from ..bls import api as bls
from .store import ValidatorStore


@dataclass
class AttesterDuty:
    pubkey: bytes
    validator_index: int
    committee_index: int
    committee_length: int
    slot: int


@dataclass
class ProposerDuty:
    pubkey: bytes
    validator_index: int
    slot: int


class ValidatorService:
    def __init__(self, config, types, chain, store: ValidatorStore, metrics=None):
        self.metrics = metrics
        self.config = config
        self.types = types
        self.chain = chain
        self.store = store
        self._indices: dict[bytes, int] | None = None

    # -- duty discovery (reference attestationDuties/blockDuties) ------------

    def _validator_indices(self) -> dict[bytes, int]:
        if self._indices is None:
            self._indices = {}
        ctx = self.chain.head_state.epoch_ctx
        for pk in self.store.pubkeys:
            if pk not in self._indices:
                idx = ctx.pubkey_to_index.get(pk)
                if idx is not None:
                    self._indices[pk] = idx
        return self._indices

    def get_attester_duties(self, epoch: int) -> list[AttesterDuty]:
        state = self.chain.head_state
        ctx = state.epoch_ctx
        indices = self._validator_indices()
        by_index = {v: k for k, v in indices.items()}
        duties = []
        spe = self.config.preset.SLOTS_PER_EPOCH
        start = epoch * spe
        for slot in range(start, start + spe):
            for cidx in range(ctx.get_committee_count_per_slot(epoch)):
                committee = ctx.get_beacon_committee(slot, cidx)
                for pos, vidx in enumerate(committee):
                    pk = by_index.get(int(vidx))
                    if pk is not None:
                        duties.append(
                            AttesterDuty(
                                pubkey=pk,
                                validator_index=int(vidx),
                                committee_index=cidx,
                                committee_length=len(committee),
                                slot=slot,
                            )
                        )
        return duties

    def get_proposer_duties(self, epoch: int) -> list[ProposerDuty]:
        ctx = self.chain.head_state.epoch_ctx
        if epoch != ctx.current_epoch:
            raise ValueError("proposer duties only for the current epoch")
        indices = self._validator_indices()
        by_index = {v: k for k, v in indices.items()}
        spe = self.config.preset.SLOTS_PER_EPOCH
        out = []
        for i, proposer in enumerate(ctx.proposers):
            pk = by_index.get(proposer)
            if pk is not None:
                out.append(
                    ProposerDuty(
                        pubkey=pk, validator_index=proposer, slot=epoch * spe + i
                    )
                )
        return out

    # -- per-slot work (reference attestation.ts / block.ts services) --------

    def propose_block_if_due(self, slot: int):
        """If one of our validators proposes at `slot`, produce + sign +
        import the block. Returns the signed block or None."""
        from ..state_transition import process_slots

        trial = self.chain.head_state.copy()
        if slot > trial.state.slot:
            process_slots(trial, self.types, slot)
        proposer = trial.epoch_ctx.get_beacon_proposer(slot)
        by_index = {v: k for k, v in self._validator_indices().items()}
        pk = by_index.get(proposer)
        if pk is None:
            return None
        import time as _t

        _t0 = _t.monotonic()
        reveal = self.store.sign_randao(pk, slot)
        block = self.chain.produce_block(slot, randao_reveal=reveal)
        signed = self.store.sign_block(pk, self.types, block)
        if self.metrics is not None:
            self.metrics.vc_signer_seconds.observe(
                _t.monotonic() - _t0, kind="block"
            )
        try:
            self.chain.process_block(signed)
        except Exception:
            if self.metrics is not None:
                self.metrics.vc_duties_total.inc(kind="block", outcome="error")
            raise
        if self.metrics is not None:
            self.metrics.vc_duties_total.inc(kind="block", outcome="published")
        return signed

    def attest_if_due(self, slot: int) -> list:
        """Produce + sign + publish attestations for all our duties at
        `slot` (head vote at slot/3 semantics; here: after head update)."""
        state = self.chain.head_state
        ctx = state.epoch_ctx
        epoch = slot // self.config.preset.SLOTS_PER_EPOCH
        spe = self.config.preset.SLOTS_PER_EPOCH
        start = epoch * spe
        head_root = self.chain.head_root
        if start == slot:
            target_root = head_root
        else:
            target_root = bytes(
                state.state.block_roots[
                    start % self.config.preset.SLOTS_PER_HISTORICAL_ROOT
                ]
            )
        indices = self._validator_indices()
        produced = []
        for cidx in range(ctx.get_committee_count_per_slot(epoch)):
            committee = ctx.get_beacon_committee(slot, cidx)
            members = {int(v): pos for pos, v in enumerate(committee)}
            ours = [
                (pk, idx) for pk, idx in indices.items() if idx in members
            ]
            if not ours:
                continue
            data = self.types.AttestationData(
                slot=slot,
                index=cidx,
                beacon_block_root=head_root,
                source=state.state.current_justified_checkpoint.copy(),
                target=self.types.Checkpoint(epoch=epoch, root=target_root),
            )
            sigs = []
            bits = [False] * len(committee)
            for pk, idx in ours:
                import time as _t

                _t0 = _t.monotonic()
                sig = self.store.sign_attestation(pk, data)
                if self.metrics is not None:
                    self.metrics.vc_signer_seconds.observe(
                        _t.monotonic() - _t0, kind="attestation"
                    )
                    self.metrics.vc_duties_total.inc(
                        kind="attestation", outcome="signed"
                    )
                sigs.append(bls.Signature.from_bytes(sig, validate=False))
                bits[members[idx]] = True
            att = self.types.Attestation(
                aggregation_bits=bits,
                data=data,
                signature=bls.aggregate_signatures(sigs).to_bytes(),
            )
            self.chain.on_aggregated_attestation(att, data.hash_tree_root())
            produced.append(att)
        return produced

    def aggregate_if_due(self, slot: int, attestations: list) -> list:
        """Build SignedAggregateAndProof for every duty where one of our
        validators is the selected aggregator of its committee (reference
        AttestationService aggregation phase at 2·slot/3)."""
        state = self.chain.head_state
        ctx = state.epoch_ctx
        epoch = slot // self.config.preset.SLOTS_PER_EPOCH
        indices = self._validator_indices()
        by_committee = {
            (int(a.data.slot), int(a.data.index)): a for a in attestations
        }
        out = []
        for cidx in range(ctx.get_committee_count_per_slot(epoch)):
            committee = [int(v) for v in ctx.get_beacon_committee(slot, cidx)]
            ours = [(pk, idx) for pk, idx in indices.items() if idx in committee]
            for pk, idx in ours:
                # the selection proof doubles as the aggregator lottery
                # ticket — sign once, reuse for the check and the envelope
                proof = self.store.sign_selection_proof(pk, slot)
                if not self.store.is_aggregator(slot, len(committee), pk, proof=proof):
                    continue
                agg = by_committee.get((slot, cidx))
                if agg is None:
                    continue
                agg_and_proof = self.types.AggregateAndProof(
                    aggregator_index=idx,
                    aggregate=agg.copy(),
                    selection_proof=proof,
                )
                out.append(
                    self.store.sign_aggregate_and_proof(pk, self.types, agg_and_proof)
                )
        return out
