"""Gossip handlers: topic → bounded validation queue → chain.

Reference: `network/gossip/handlers/index.ts:76+` (decode, validate,
act on ACCEPT, penalize on REJECT) and the per-topic-type queues of
`network/gossip/validation/queue.ts:10-22`:

    beacon_attestation            LIFO  maxLen 24,576  concurrency 64
    beacon_aggregate_and_proof    LIFO   maxLen 5,120  concurrency 16
    beacon_block                  FIFO   maxLen 1,024  concurrency 1
    (everything else)             FIFO   maxLen 4,096  concurrency 16

Queues keep slow validation (BLS, regen) from starving the router;
LIFO prefers fresh attestations under backlog, exactly like the
reference. The decoded-object cache avoids double-decode between the
router's validator callback and the post-accept side effects.

(The port's copy of the JAX package's `network/gossip/handlers.py`.)
"""

from __future__ import annotations

import logging
from ...chain.validation import (
    GossipAction,
    validate_gossip_aggregate_and_proof,
    validate_gossip_attestation,
    validate_gossip_attester_slashing,
    validate_gossip_block,
    validate_gossip_proposer_slashing,
    validate_gossip_voluntary_exit,
)
from ...observability import spans as _spans
from ...utils.queue import JobItemQueue, QueueType
from .encoding import decode_message
from .gossipsub import ValidationResult
from .topic import GossipType, parse_topic

log = logging.getLogger(__name__)

QUEUE_OPTS: dict[GossipType, tuple[QueueType, int, int]] = {
    GossipType.beacon_attestation: (QueueType.LIFO, 24_576, 64),
    GossipType.beacon_aggregate_and_proof: (QueueType.LIFO, 5_120, 16),
    GossipType.beacon_block: (QueueType.FIFO, 1_024, 1),
}
DEFAULT_QUEUE = (QueueType.FIFO, 4_096, 16)

_ACTION_TO_RESULT = {
    GossipAction.ACCEPT: ValidationResult.ACCEPT,
    GossipAction.IGNORE: ValidationResult.IGNORE,
    GossipAction.REJECT: ValidationResult.REJECT,
}


class GossipHandlers:
    """Owns the validation queues and the per-type handler logic."""

    def __init__(self, config, types, chain, verify_signatures: bool = True,
                 fleet_router=None, persist_invalid_dir: str | None = None):
        self.config = config
        # where blocks that fail import are written for debugging (the JAX
        # package reads LODESTAR_TPU_PERSIST_INVALID; None is its default, off)
        self.persist_invalid_dir = persist_invalid_dir
        self.types = types
        self.chain = chain
        self.verify_signatures = verify_signatures
        # subnet → host routing for fleet ingest (parallel/fleet.py);
        # None = single-host node, validate every subnet. Node wiring may
        # also bind this post-construction (node.attach_network).
        self.fleet_router = fleet_router
        self.queues: dict[GossipType, JobItemQueue] = {}
        for gtype in GossipType:
            qt, max_len, conc = QUEUE_OPTS.get(gtype, DEFAULT_QUEUE)
            self.queues[gtype] = JobItemQueue(
                self._process,
                max_length=max_len,
                max_concurrency=conc,
                queue_type=qt,
                name=f"gossip.{gtype.value}",
            )

    def register(self, router) -> None:
        """Install one validator per topic type on the gossipsub router
        (prefix-matched, so every fork digest and subnet is covered)."""
        async def validator(topic_str: str, wire: bytes) -> ValidationResult:
            try:
                topic = parse_topic(topic_str)
            except ValueError:
                return ValidationResult.REJECT
            queue = self.queues[topic.type]
            try:
                return await queue.push((topic, wire))
            except Exception:
                return ValidationResult.IGNORE  # queue full / closed

        # the router prefix-matches on "/eth2/" — one validator for all
        router.validators["/eth2/"] = validator

    # -- queue processor -----------------------------------------------------

    async def _process(self, item) -> ValidationResult:
        import asyncio

        topic, wire = item
        # one lifecycle trace per gossip message: wire decode → validation
        # ladder → (for blocks) bls verify → fork choice → import → head
        # update, all correlated under one trace-id (observability.spans)
        with _spans.tracer.trace(
            f"gossip/{topic.type.value}", kind=topic.type.value
        ):
            with _spans.tracer.span("gossip/decode", wire_bytes=len(wire)):
                try:
                    ssz = decode_message(wire)
                except ValueError:
                    return ValidationResult.REJECT
            from ...ssz import DeserializationError

            # run_in_executor does not copy contextvars: hand the worker
            # thread the live span explicitly so its spans stay correlated
            trace_ctx = _spans.tracer.context()
            try:
                # run validation + import in an executor thread: the handler
                # does BLS verification and may wait on the chain's import
                # lock (held by range sync), neither of which may stall the
                # event loop
                return await asyncio.get_running_loop().run_in_executor(
                    None, self._handle_traced, trace_ctx, topic, ssz
                )
            except DeserializationError:
                return ValidationResult.REJECT  # undecodable object = bad peer
            except Exception as e:  # noqa: BLE001 — a handler bug must not REJECT
                log.debug(f"handler error on {topic.type.value}: {e}")
                return ValidationResult.IGNORE

    def _handle_traced(self, trace_ctx, topic, ssz: bytes) -> ValidationResult:
        with _spans.tracer.attach(trace_ctx):
            return self._handle(topic, ssz)

    def _handle(self, topic, ssz: bytes) -> ValidationResult:
        chain, types = self.chain, self.types
        t = topic.type

        if t is GossipType.beacon_block:
            signed = types.SignedBeaconBlock.deserialize(ssz)
            slot = int(signed.message.slot)
            _spans.tracer.annotate(
                slot=slot, root=signed.message.hash_tree_root().hex()
            )
            _milestone(chain, "block_received", slot)
            with _spans.tracer.span("validation/block", slot=slot):
                result = validate_gossip_block(chain, types, signed)
            if result.action is GossipAction.ACCEPT:
                _milestone(chain, "validated", slot)
                chain.seen_block_proposers.add(
                    slot, int(signed.message.proposer_index)
                )
                try:
                    chain.process_block(
                        signed, verify_signatures=self.verify_signatures
                    )
                except Exception as e:
                    log.debug(f"gossip block import failed: {e}")
                    _persist_invalid_ssz(self.persist_invalid_dir, signed, "block", e)
                    return ValidationResult.REJECT
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.beacon_attestation:
            # subnet-sharded fleet ingest: when a FleetRouter
            # is bound, this host only validates (and BLS-verifies) the
            # attestation subnets it owns — foreign-slice traffic is
            # IGNOREd before the validation ladder, so the lane
            # dispatcher sees exactly this host's share of the fleet
            # load. IGNORE (not REJECT): the attestation is not invalid,
            # it is simply another host's work.
            router = self.fleet_router
            if router is not None and topic.subnet is not None:
                try:
                    foreign = not router.owns(int(topic.subnet))
                except Exception:  # noqa: BLE001 — routing must not drop valid work
                    foreign = False
                if foreign:
                    router.record_foreign(int(topic.subnet))
                    return ValidationResult.IGNORE
            att = types.Attestation.deserialize(ssz)
            with _spans.tracer.span(
                "validation/attestation", slot=int(att.data.slot)
            ):
                result = validate_gossip_attestation(
                    chain, types, att, topic.subnet
                )
            if result.action is GossipAction.ACCEPT:
                chain.on_gossip_attestation(att, result.data_root)
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.beacon_aggregate_and_proof:
            signed_agg = types.SignedAggregateAndProof.deserialize(ssz)
            with _spans.tracer.span(
                "validation/aggregate",
                slot=int(signed_agg.message.aggregate.data.slot),
            ):
                result = validate_gossip_aggregate_and_proof(
                    chain, types, signed_agg
                )
            if result.action is GossipAction.ACCEPT:
                chain.on_aggregated_attestation(
                    signed_agg.message.aggregate, result.data_root
                )
                monitor = getattr(chain, "validator_monitor", None)
                if monitor is not None:
                    monitor.on_aggregate_published(
                        int(signed_agg.message.aggregate.data.target.epoch),
                        int(signed_agg.message.aggregator_index),
                    )
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.voluntary_exit:
            signed_exit = types.SignedVoluntaryExit.deserialize(ssz)
            result = validate_gossip_voluntary_exit(chain, types, signed_exit)
            if result.action is GossipAction.ACCEPT:
                chain.op_pool.add_voluntary_exit(signed_exit)
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.proposer_slashing:
            slashing = types.ProposerSlashing.deserialize(ssz)
            result = validate_gossip_proposer_slashing(chain, types, slashing)
            if result.action is GossipAction.ACCEPT:
                chain.op_pool.add_proposer_slashing(slashing)
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.attester_slashing:
            slashing = types.AttesterSlashing.deserialize(ssz)
            result = validate_gossip_attester_slashing(chain, types, slashing)
            if result.action is GossipAction.ACCEPT:
                chain.op_pool.add_attester_slashing(slashing)
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.sync_committee:
            if not hasattr(types, "SyncCommitteeMessage"):
                return ValidationResult.IGNORE
            msg = types.SyncCommitteeMessage.deserialize(ssz)
            from ...chain.validation import validate_gossip_sync_committee

            result = validate_gossip_sync_committee(
                chain, types, msg, topic.subnet if topic.subnet is not None else 0
            )
            if result.action is GossipAction.ACCEPT:
                pool = getattr(chain, "sync_committee_pool", None)
                if pool is not None and topic.subnet is not None:
                    # a validator can hold several positions in one
                    # subcommittee (sampling with replacement): set all
                    # of its bits from this first-seen message
                    for pos in result.positions or [result.attesting_index or 0]:
                        pool.add(msg, topic.subnet, pos)
                monitor = getattr(chain, "validator_monitor", None)
                if monitor is not None:
                    spe = chain.preset.SLOTS_PER_EPOCH
                    monitor.on_sync_committee_message(
                        int(msg.slot) // spe, int(msg.validator_index)
                    )
            return _ACTION_TO_RESULT[result.action]

        if t is GossipType.sync_committee_contribution_and_proof:
            if not hasattr(types, "SignedContributionAndProof"):
                return ValidationResult.IGNORE
            signed = types.SignedContributionAndProof.deserialize(ssz)
            from ...chain.validation import (
                validate_gossip_sync_contribution_and_proof,
            )

            result = validate_gossip_sync_contribution_and_proof(
                chain, types, signed
            )
            if result.action is GossipAction.ACCEPT:
                pool = getattr(chain, "sync_contribution_pool", None)
                if pool is not None:
                    pool.add(signed.message.contribution)
            return _ACTION_TO_RESULT[result.action]

        # light-client updates: served, not consumed, by full nodes
        return ValidationResult.IGNORE


def _milestone(chain, name: str, slot: int) -> None:
    """Record a slot milestone via the chain (which owns the clock and the
    metrics bundle); tolerant of stub chains in tests."""
    rec = getattr(chain, "_record_milestone", None)
    if rec is not None:
        try:
            rec(name, slot)
        except Exception as e:
            # milestone telemetry must never fail the handler
            log.debug("milestone %s failed: %s", name, e)


def _persist_invalid_ssz(target: str | None, obj, kind: str, error: Exception) -> None:
    """Debugging dump of objects that failed import into `target` (reference
    `persistInvalidSszValue`, `chain/blocks/index.ts:117-135`); None is
    off. Filenames carry kind + root."""
    import os

    if not target:
        return
    try:
        os.makedirs(target, exist_ok=True)
        root = obj.message.hash_tree_root().hex()[:16] if hasattr(obj, "message") else "obj"
        path = os.path.join(target, f"invalid_{kind}_{root}.ssz")
        with open(path, "wb") as f:
            f.write(obj.serialize())
        with open(path + ".log", "w") as f:
            f.write(f"{type(error).__name__}: {error}\n")
        log.warning("persisted invalid %s to %s", kind, path)
    except Exception as e:
        log.debug("failed to persist invalid %s: %s", kind, e)  # diagnostics only
