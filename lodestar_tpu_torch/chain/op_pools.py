"""Operation mempools.

Reference: `chain/opPools/` — `AttestationPool` (unaggregated, per-slot,
aggregates on insert), `AggregatedAttestationPool` (block packing via
greedy not-yet-seen coverage, `aggregatedAttestationPool.ts:108`),
`OpPool` (slashings + exits)."""

from __future__ import annotations

from ..bls import api as bls


class AttestationPool:
    """Unaggregated gossip attestations, aggregated on insert per
    (slot, data_root). Signature aggregation is G2 point addition in the
    C host tier, the aggregate kept compressed (the JAX pool keeps the
    oracle's point); retained for SLOTS_RETAINED slots."""

    SLOTS_RETAINED = 3

    def __init__(self):
        # slot → data_root → (data, bits list[bool], agg signature bytes)
        self._by_slot: dict[int, dict[bytes, tuple[object, list[bool], object]]] = {}

    def add(self, attestation, data_root: bytes) -> str:
        slot = attestation.data.slot
        by_root = self._by_slot.setdefault(slot, {})
        bits = list(attestation.aggregation_bits)
        sig = bls.Signature.from_bytes(bytes(attestation.signature), validate=False)
        entry = by_root.get(data_root)
        if entry is None:
            by_root[data_root] = (attestation.data.copy(), bits, sig.to_bytes())
            return "added"
        data, agg_bits, agg_sig = entry
        new_bits = [b for b in bits]
        if all(ab or not nb for ab, nb in zip(agg_bits, new_bits)):
            return "already_known"
        merged = [a or b for a, b in zip(agg_bits, new_bits)]
        agg = bls.aggregate_signatures([bls.Signature(agg_sig), sig]).to_bytes()
        by_root[data_root] = (data, merged, agg)
        return "aggregated"

    def get_aggregate(self, slot: int, data_root: bytes):
        entry = self._by_slot.get(slot, {}).get(data_root)
        if entry is None:
            return None
        data, bits, sig = entry
        return data, bits, bls.Signature(sig)

    def prune(self, clock_slot: int) -> None:
        self._by_slot = {
            s: v
            for s, v in self._by_slot.items()
            if s >= clock_slot - self.SLOTS_RETAINED
        }


class AggregatedAttestationPool:
    """Aggregates (from gossip aggregate-and-proof or local aggregation)
    grouped by (target epoch, data root); `get_attestations_for_block`
    packs greedily by fresh-coverage count (reference
    getAttestationsForBlock)."""

    EPOCHS_RETAINED = 2

    def __init__(self):
        # data_root → (data, list[(bits, signature_bytes)])
        self._by_root: dict[bytes, tuple[object, list[tuple[list[bool], bytes]]]] = {}
        self._epoch_of_root: dict[bytes, int] = {}

    def add(self, attestation, data_root: bytes) -> None:
        """Insert, merging into an existing variant when bit-disjoint
        (reference aggregateInto: OR the bits, aggregate the signatures) —
        partial aggregates from different nodes combine into full ones."""
        from ..bls import api as bls

        bits = list(attestation.aggregation_bits)
        sig = bytes(attestation.signature)
        data, variants = self._by_root.setdefault(
            data_root, (attestation.data.copy(), [])
        )
        self._epoch_of_root[data_root] = attestation.data.target.epoch
        for i, (vbits, vsig) in enumerate(variants):
            if len(vbits) != len(bits):
                continue
            if all(v or not b for v, b in zip(vbits, bits)):
                return  # non-strict subset of an existing variant: redundant
            if not any(v and b for v, b in zip(vbits, bits)):
                merged_sig = bls.aggregate_signatures(
                    [
                        bls.Signature.from_bytes(vsig, validate=False),
                        bls.Signature.from_bytes(sig, validate=False),
                    ]
                ).to_bytes()
                variants[i] = (
                    [v or b for v, b in zip(vbits, bits)],
                    merged_sig,
                )
                return
        variants.append((bits, sig))

    def get_attestations_for_block(self, types, cached, max_attestations: int):
        """Pick the best variant per data root, preferring recent slots and
        maximal coverage; validity-filter against the block's state."""
        state = cached.state
        p = cached.preset
        candidates = []
        for data_root, (data, variants) in self._by_root.items():
            if not (
                data.slot + p.MIN_ATTESTATION_INCLUSION_DELAY
                <= state.slot
                <= data.slot + p.SLOTS_PER_EPOCH
            ):
                continue
            epoch = data.target.epoch
            if epoch == cached.current_epoch:
                if data.source != state.current_justified_checkpoint:
                    continue
            elif epoch == cached.previous_epoch:
                if data.source != state.previous_justified_checkpoint:
                    continue
            else:
                continue
            best = max(variants, key=lambda v: sum(v[0]))
            candidates.append((sum(best[0]), data.slot, data, best))
        candidates.sort(key=lambda c: (-c[1], -c[0]))  # recent slots, most bits
        out = []
        for _, _, data, (bits, sig) in candidates[:max_attestations]:
            out.append(
                types.Attestation(
                    aggregation_bits=bits, data=data.copy(), signature=sig
                )
            )
        return out

    def prune(self, current_epoch: int) -> None:
        stale = [
            r
            for r, e in self._epoch_of_root.items()
            if e + self.EPOCHS_RETAINED < current_epoch
        ]
        for r in stale:
            self._by_root.pop(r, None)
            self._epoch_of_root.pop(r, None)


class OpPool:
    """Slashings, exits — persisted ops awaiting block inclusion
    (reference opPool.ts; per-validator dedup)."""

    def __init__(self):
        self.proposer_slashings: dict[int, object] = {}
        self.attester_slashings: list[object] = []
        self.voluntary_exits: dict[int, object] = {}

    def add_proposer_slashing(self, slashing) -> None:
        self.proposer_slashings[slashing.signed_header_1.message.proposer_index] = (
            slashing
        )

    def add_attester_slashing(self, slashing) -> None:
        self.attester_slashings.append(slashing)

    def add_voluntary_exit(self, signed_exit) -> None:
        self.voluntary_exits[signed_exit.message.validator_index] = signed_exit

    def get_slashings_and_exits(self, cached, preset):
        from ..state_transition.block import is_slashable_validator

        proposer = [
            s
            for idx, s in self.proposer_slashings.items()
            if is_slashable_validator(cached.flat, idx, cached.current_epoch)
        ][: preset.MAX_PROPOSER_SLASHINGS]
        attester = self.attester_slashings[: preset.MAX_ATTESTER_SLASHINGS]
        exits = [
            e
            for idx, e in self.voluntary_exits.items()
            if int(cached.flat.exit_epoch[idx]) == 2**64 - 1
        ][: preset.MAX_VOLUNTARY_EXITS]
        return proposer, attester, exits

    def prune(self, cached) -> None:
        self.proposer_slashings = {
            i: s
            for i, s in self.proposer_slashings.items()
            if not bool(cached.flat.slashed[i])
        }
        self.voluntary_exits = {
            i: e
            for i, e in self.voluntary_exits.items()
            if int(cached.flat.exit_epoch[i]) == 2**64 - 1
        }


class SyncCommitteeMessagePool:
    """Per-subnet aggregation of individual sync-committee messages into
    contributions (reference syncCommitteeMessagePool.ts: bits + aggregated
    signature per (slot, block_root, subcommittee))."""

    SLOTS_RETAINED = 3

    def __init__(self, preset):
        self.preset = preset
        from ..params import SYNC_COMMITTEE_SUBNET_COUNT

        self.subnet_size = preset.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        # (slot, root, subcommittee) → (bits list, list[signature bytes])
        self._store: dict[tuple[int, bytes, int], tuple[list[bool], list[bytes]]] = {}

    def add(self, message, subcommittee_index: int, position_in_subcommittee: int):
        key = (message.slot, bytes(message.beacon_block_root), subcommittee_index)
        bits, sigs = self._store.setdefault(
            key, ([False] * self.subnet_size, [])
        )
        if bits[position_in_subcommittee]:
            return  # duplicate participant
        bits[position_in_subcommittee] = True
        sigs.append(bytes(message.signature))

    def get_contribution(self, types, slot: int, block_root: bytes, subcommittee: int):
        from ..bls import api as bls

        entry = self._store.get((slot, bytes(block_root), subcommittee))
        if entry is None:
            return None
        bits, sigs = entry
        agg = bls.aggregate_signatures(
            [bls.Signature.from_bytes(s, validate=False) for s in sigs]
        )
        return types.SyncCommitteeContribution(
            slot=slot,
            beacon_block_root=bytes(block_root),
            subcommittee_index=subcommittee,
            aggregation_bits=list(bits),
            signature=agg.to_bytes(),
        )

    def prune(self, clock_slot: int) -> None:
        self._store = {
            k: v for k, v in self._store.items() if k[0] + self.SLOTS_RETAINED >= clock_slot
        }


class SyncContributionAndProofPool:
    """Best contribution per (slot, root, subcommittee), merged into the
    block's SyncAggregate (reference syncContributionAndProofPool.ts
    `getAggregate`)."""

    SLOTS_RETAINED = 3

    def __init__(self, preset):
        self.preset = preset
        from ..params import SYNC_COMMITTEE_SUBNET_COUNT

        self.subnet_count = SYNC_COMMITTEE_SUBNET_COUNT
        self.subnet_size = preset.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        # (slot, root, subcommittee) → best contribution (most bits)
        self._best: dict[tuple[int, bytes, int], object] = {}

    def add(self, contribution) -> None:
        key = (
            contribution.slot,
            bytes(contribution.beacon_block_root),
            contribution.subcommittee_index,
        )
        existing = self._best.get(key)
        if existing is None or sum(contribution.aggregation_bits) > sum(
            existing.aggregation_bits
        ):
            self._best[key] = contribution.copy()

    def get_sync_aggregate(self, types, slot: int, block_root: bytes):
        """SyncAggregate for a block at `slot` signing `block_root` (the
        parent). Empty participation → infinity signature, per spec."""
        from ..bls import api as bls

        bits = [False] * self.preset.SYNC_COMMITTEE_SIZE
        sigs = []
        for sub in range(self.subnet_count):
            contrib = self._best.get((slot, bytes(block_root), sub))
            if contrib is None:
                continue
            for i, b in enumerate(contrib.aggregation_bits):
                if b:
                    bits[sub * self.subnet_size + i] = True
            sigs.append(
                bls.Signature.from_bytes(bytes(contrib.signature), validate=False)
            )
        if not sigs:
            return types.SyncAggregate(
                sync_committee_bits=bits,
                sync_committee_signature=b"\xc0" + b"\x00" * 95,
            )
        return types.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=bls.aggregate_signatures(sigs).to_bytes(),
        )

    def prune(self, clock_slot: int) -> None:
        self._best = {
            k: v for k, v in self._best.items() if k[0] + self.SLOTS_RETAINED >= clock_slot
        }


class BlsToExecutionChangePool:
    """Pending capella credential changes, deduped per validator
    (reference opPool bls_to_execution_changes handling)."""

    def __init__(self):
        self._by_validator: dict[int, object] = {}

    def add(self, signed_change) -> None:
        self._by_validator.setdefault(
            signed_change.message.validator_index, signed_change
        )

    def get_for_block(self, cached, preset) -> list:
        from ..params import BLS_WITHDRAWAL_PREFIX

        out = []
        for idx, change in self._by_validator.items():
            if idx >= len(cached.state.validators):
                continue
            wc = bytes(cached.state.validators[idx].withdrawal_credentials)
            if wc[:1] == BLS_WITHDRAWAL_PREFIX:
                out.append(change)
            if len(out) == preset.MAX_BLS_TO_EXECUTION_CHANGES:
                break
        return out

    def prune(self, cached) -> None:
        from ..params import BLS_WITHDRAWAL_PREFIX

        self._by_validator = {
            i: c
            for i, c in self._by_validator.items()
            if i < len(cached.state.validators)
            and bytes(cached.state.validators[i].withdrawal_credentials)[:1]
            == BLS_WITHDRAWAL_PREFIX
        }
