"""Anti-duplication gossip caches (reference: `chain/seenCache/*.ts` —
SeenAttesters, SeenAggregators, SeenBlockProposers, SeenAggregatedAttestations).

Epoch-keyed maps pruned on finalization; the aggregated-attestation cache
keeps seen aggregation-bit sets per attestation-data root and answers
non-strict-superset queries ("is this aggregate already covered?")."""

from __future__ import annotations


class SeenByEpoch:
    """epoch → {validator index} (SeenAttesters / SeenAggregators)."""

    def __init__(self):
        self._by_epoch: dict[int, set[int]] = {}
        self.lowest_permissible_epoch = 0

    def is_known(self, epoch: int, index: int) -> bool:
        return index in self._by_epoch.get(epoch, ())

    def add(self, epoch: int, index: int) -> None:
        if epoch < self.lowest_permissible_epoch:
            raise ValueError("epoch below pruned horizon")
        self._by_epoch.setdefault(epoch, set()).add(index)

    def prune(self, finalized_epoch: int) -> None:
        self.lowest_permissible_epoch = finalized_epoch
        self._by_epoch = {
            e: s for e, s in self._by_epoch.items() if e >= finalized_epoch
        }


SeenAttesters = SeenByEpoch
SeenAggregators = SeenByEpoch


class SeenBlockProposers:
    """slot → {proposer index} (duplicate block proposal detection)."""

    def __init__(self):
        self._by_slot: dict[int, set[int]] = {}

    def is_known(self, slot: int, proposer: int) -> bool:
        return proposer in self._by_slot.get(slot, ())

    def add(self, slot: int, proposer: int) -> None:
        self._by_slot.setdefault(slot, set()).add(proposer)

    def prune(self, finalized_slot: int) -> None:
        self._by_slot = {s: v for s, v in self._by_slot.items() if s >= finalized_slot}


class SeenAggregatedAttestations:
    """data_root → list of seen aggregation-bit tuples; an incoming
    aggregate is redundant iff some seen bitset is a non-strict superset
    (reference seenAggregatedAttestations non-strict superset check)."""

    def __init__(self):
        self._by_root: dict[bytes, list[tuple[bool, ...]]] = {}
        self._epoch_of_root: dict[bytes, int] = {}

    def is_known_superset(self, data_root: bytes, bits: list[bool]) -> bool:
        for seen in self._by_root.get(data_root, ()):
            if len(seen) == len(bits) and all(
                s or not b for s, b in zip(seen, bits)
            ):
                return True
        return False

    def add(self, epoch: int, data_root: bytes, bits: list[bool]) -> None:
        entry = tuple(bits)
        existing = self._by_root.setdefault(data_root, [])
        # drop strictly-dominated entries to bound growth
        existing[:] = [
            s for s in existing
            if not (len(s) == len(entry) and all(e or not b for e, b in zip(entry, s)))
        ]
        existing.append(entry)
        self._epoch_of_root[data_root] = epoch

    def prune(self, finalized_epoch: int) -> None:
        stale = [r for r, e in self._epoch_of_root.items() if e < finalized_epoch]
        for r in stale:
            self._by_root.pop(r, None)
            self._epoch_of_root.pop(r, None)


class SeenSyncCommitteeMessages:
    """First-seen per (slot, subnet, validator) — the [IGNORE] dedup of the
    sync_committee_{subnet} topic (reference seenCache/seenCommittee.ts)."""

    SLOTS_RETAINED = 3

    def __init__(self):
        self._seen: set[tuple[int, int, int]] = set()

    def is_known(self, slot: int, subnet: int, validator_index: int) -> bool:
        return (slot, subnet, validator_index) in self._seen

    def add(self, slot: int, subnet: int, validator_index: int) -> None:
        self._seen.add((slot, subnet, validator_index))

    def prune(self, clock_slot: int) -> None:
        self._seen = {
            k for k in self._seen if k[0] + self.SLOTS_RETAINED >= clock_slot
        }


class SeenContributionAndProof:
    """Dedup for sync_committee_contribution_and_proof: first-seen per
    aggregator (slot, subcommittee, aggregator_index) plus the non-strict
    participant-superset check per (slot, root, subcommittee) (reference
    seenCache/seenGossipBlockInput... seenContributionAndProof.ts
    participantsKnown/isAggregatorKnown)."""

    SLOTS_RETAINED = 3

    def __init__(self):
        self._aggregators: set[tuple[int, int, int]] = set()
        self._participants: dict[tuple[int, bytes, int], list[list[bool]]] = {}

    def is_aggregator_known(
        self, slot: int, subcommittee: int, aggregator_index: int
    ) -> bool:
        return (slot, subcommittee, aggregator_index) in self._aggregators

    def participants_known(self, contribution) -> bool:
        """True when some already-seen contribution's bits are a non-strict
        superset of this contribution's bits."""
        key = (
            int(contribution.slot),
            bytes(contribution.beacon_block_root),
            int(contribution.subcommittee_index),
        )
        bits = list(contribution.aggregation_bits)
        for seen in self._participants.get(key, []):
            if all(s or not b for s, b in zip(seen, bits)):
                return True
        return False

    def add(self, contribution_and_proof) -> None:
        c = contribution_and_proof.contribution
        self._aggregators.add(
            (
                int(c.slot),
                int(c.subcommittee_index),
                int(contribution_and_proof.aggregator_index),
            )
        )
        key = (int(c.slot), bytes(c.beacon_block_root), int(c.subcommittee_index))
        self._participants.setdefault(key, []).append(list(c.aggregation_bits))

    def prune(self, clock_slot: int) -> None:
        self._aggregators = {
            k for k in self._aggregators if k[0] + self.SLOTS_RETAINED >= clock_slot
        }
        self._participants = {
            k: v
            for k, v in self._participants.items()
            if k[0] + self.SLOTS_RETAINED >= clock_slot
        }
