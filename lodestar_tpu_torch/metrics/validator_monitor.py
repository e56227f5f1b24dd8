"""ValidatorMonitor: per-validator duty tracking for operators.

Reference: `metrics/validatorMonitor.ts` (478 LoC) — registered validator
indices get per-epoch summaries (attestation seen on gossip / included in
a block, inclusion distance, head/target correctness, blocks proposed,
aggregates, sync-committee signatures, balance deltas) surfaced as
metrics and epoch-end log lines.

The port's copy of the JAX package's `metrics/validator_monitor.py`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EpochSummary:
    # attestation lifecycle (reference: registerGossipAttestation /
    # registerAttestationInBlock)
    attestation_seen: bool = False          # observed on gossip
    attestation_seen_delay_sec: float = 0.0
    attestation_included: bool = False      # landed in a block
    inclusion_distance: int = 0
    target_correct: bool = False
    head_correct: bool = False
    # aggregation duties
    aggregates_published: int = 0
    attestation_in_aggregate: bool = False
    # proposals
    blocks_proposed: int = 0
    block_seen_delay_sec: float = 0.0
    # sync committee
    sync_signatures: int = 0
    sync_signatures_included: int = 0
    # rewards proxy
    balance_gwei: int = 0


class ValidatorMonitor:
    def __init__(self, registry=None):
        self._monitored: set[int] = set()
        self._summaries: dict[tuple[int, int], EpochSummary] = {}
        self._metrics = None
        if registry is not None:
            label = ("index",)
            self._metrics = {
                "seen": registry.counter(
                    "validator_monitor_attestation_seen_total",
                    "monitored validators' attestations observed on gossip",
                    label_names=label,
                ),
                "included": registry.counter(
                    "validator_monitor_attestation_included_total",
                    "attestations included for monitored validators",
                    label_names=label,
                ),
                "missed": registry.counter(
                    "validator_monitor_attestation_missed_total",
                    "attestations missed for monitored validators",
                    label_names=label,
                ),
                "distance": registry.histogram(
                    "validator_monitor_inclusion_distance",
                    "inclusion distance of monitored attestations",
                    buckets=(1, 2, 3, 4, 5, 8, 16, 32),
                ),
                "target_miss": registry.counter(
                    "validator_monitor_target_incorrect_total",
                    "included attestations with the wrong target",
                    label_names=label,
                ),
                "head_miss": registry.counter(
                    "validator_monitor_head_incorrect_total",
                    "included attestations with the wrong head",
                    label_names=label,
                ),
                "proposed": registry.counter(
                    "validator_monitor_blocks_proposed_total",
                    "blocks proposed by monitored validators",
                    label_names=label,
                ),
                "aggregates": registry.counter(
                    "validator_monitor_aggregates_published_total",
                    "aggregate-and-proofs from monitored aggregators",
                    label_names=label,
                ),
                "sync_sigs": registry.counter(
                    "validator_monitor_sync_signatures_total",
                    "sync-committee messages from monitored validators",
                    label_names=label,
                ),
                "sync_included": registry.counter(
                    "validator_monitor_sync_signatures_included_total",
                    "monitored sync signatures included in SyncAggregates",
                    label_names=label,
                ),
                "balance": registry.gauge(
                    "validator_monitor_balance_gwei",
                    "latest monitored validator balance",
                    label_names=label,
                ),
                # timeliness: delay from the duty's slot start to the
                # event reaching this node (reference validatorMonitor
                # *_delay_seconds families — the per-validator view of
                # the node-wide slot-milestone metrics)
                "att_delay": registry.histogram(
                    "validator_monitor_attestation_seen_delay_seconds",
                    "slot-start -> gossip-seen delay of monitored attestations",
                    buckets=(0.5, 1, 1.5, 2, 3, 4, 6, 8, 12),
                ),
                "block_delay": registry.histogram(
                    "validator_monitor_block_seen_delay_seconds",
                    "slot-start -> import delay of monitored proposals",
                    buckets=(0.5, 1, 1.5, 2, 3, 4, 6, 8, 12),
                ),
            }

    def register_validator(self, index: int) -> None:
        self._monitored.add(index)

    @property
    def monitored(self) -> set[int]:
        return set(self._monitored)

    def _summary(self, index: int, epoch: int) -> EpochSummary:
        return self._summaries.setdefault((index, epoch), EpochSummary())

    # -- event hooks (called by gossip validation / import pipeline) --------

    def on_gossip_attestation(
        self, epoch: int, index: int, delay_sec: float = 0.0
    ) -> None:
        """A monitored validator's unaggregated attestation arrived on
        gossip (reference registerGossipAttestation)."""
        if index in self._monitored:
            s = self._summary(index, epoch)
            if not s.attestation_seen:
                s.attestation_seen = True
                s.attestation_seen_delay_sec = delay_sec
                if self._metrics:
                    self._metrics["seen"].inc(index=str(index))
                    self._metrics["att_delay"].observe(delay_sec)

    def on_attestation_included(
        self, epoch: int, indices, inclusion_distance: int,
        target_correct: bool, head_correct: bool,
    ) -> None:
        for idx in indices:
            if idx in self._monitored:
                s = self._summary(idx, epoch)
                # keep the BEST observation across re-inclusions (minimum
                # distance, OR-ed correctness) — a later aggregate must not
                # degrade the report
                if s.attestation_included:
                    s.inclusion_distance = min(s.inclusion_distance, inclusion_distance)
                else:
                    s.attestation_included = True
                    s.inclusion_distance = inclusion_distance
                    if self._metrics:
                        self._metrics["included"].inc(index=str(idx))
                        self._metrics["distance"].observe(inclusion_distance)
                        if not target_correct:
                            self._metrics["target_miss"].inc(index=str(idx))
                        if not head_correct:
                            self._metrics["head_miss"].inc(index=str(idx))
                s.target_correct = s.target_correct or target_correct
                s.head_correct = s.head_correct or head_correct

    def on_attestation_in_aggregate(self, epoch: int, indices) -> None:
        for idx in indices:
            if idx in self._monitored:
                self._summary(idx, epoch).attestation_in_aggregate = True

    def on_aggregate_published(self, epoch: int, aggregator_index: int) -> None:
        if aggregator_index in self._monitored:
            self._summary(aggregator_index, epoch).aggregates_published += 1
            if self._metrics:
                self._metrics["aggregates"].inc(index=str(aggregator_index))

    def on_block_proposed(
        self, epoch: int, proposer_index: int, delay_sec: float = 0.0
    ) -> None:
        if proposer_index in self._monitored:
            s = self._summary(proposer_index, epoch)
            s.blocks_proposed += 1
            s.block_seen_delay_sec = delay_sec
            if self._metrics:
                self._metrics["proposed"].inc(index=str(proposer_index))
                self._metrics["block_delay"].observe(delay_sec)

    def on_sync_committee_message(self, epoch: int, index: int) -> None:
        if index in self._monitored:
            self._summary(index, epoch).sync_signatures += 1
            if self._metrics:
                self._metrics["sync_sigs"].inc(index=str(index))

    def on_sync_signature_included(self, epoch: int, indices) -> None:
        for idx in indices:
            if idx in self._monitored:
                self._summary(idx, epoch).sync_signatures_included += 1
                if self._metrics:
                    self._metrics["sync_included"].inc(index=str(idx))

    def on_balances(self, epoch: int, balances) -> None:
        """Record monitored balances at an epoch boundary (reference
        registerValidatorStatuses' balance tracking)."""
        for idx in self._monitored:
            if idx < len(balances):
                bal = int(balances[idx])
                self._summary(idx, epoch).balance_gwei = bal
                if self._metrics:
                    self._metrics["balance"].set(bal, index=str(idx))

    # -- epoch rollup --------------------------------------------------------

    def summarize_epoch(self, epoch: int) -> dict[int, EpochSummary]:
        """Epoch-end rollup; validators with no inclusion are counted
        missed (reference: onceEpochTransition log + metrics)."""
        out = {}
        for idx in self._monitored:
            s = self._summaries.get((idx, epoch), EpochSummary())
            out[idx] = s
            if not s.attestation_included and self._metrics:
                self._metrics["missed"].inc(index=str(idx))
        # prune old epochs
        self._summaries = {
            k: v for k, v in self._summaries.items() if k[1] >= epoch - 1
        }
        return out

    def log_epoch(self, epoch: int, log) -> None:
        """Operator-facing epoch-end line per monitored validator
        (reference logs 'validator monitor' summaries)."""
        for idx, s in sorted(self.summarize_epoch(epoch).items()):
            log.info(
                "monitor v%d e%d: att %s dist=%d target=%s head=%s "
                "props=%d aggs=%d sync=%d/%d bal=%d",
                idx, epoch,
                "included" if s.attestation_included
                else ("seen" if s.attestation_seen else "MISSED"),
                s.inclusion_distance,
                "ok" if s.target_correct else "x",
                "ok" if s.head_correct else "x",
                s.blocks_proposed, s.aggregates_published,
                s.sync_signatures_included, s.sync_signatures,
                s.balance_gwei,
            )
