"""BeaconChain: the chain aggregate + block import pipeline.

The port's copy of `lodestar_tpu/chain/chain.py`. It departs from it in
two places: with no verifier it builds the port's serving stack
(`node.bls_stack.build_bls_stack(device)`, the GPU unless `device` says
otherwise, raising without one) and serves through its lane dispatcher;
and the import wait's bound is the `import_wait_timeout_s` argument (≤ 0
disables it), not an environment variable.

Reference: `chain/chain.ts:66` (BeaconChain), `chain/blocks/` (BlockProcessor
→ verifyBlocksSanityChecks → verifyBlocksInEpoch [state transition ∥
signatures ∥ execution] → importBlock), `chain/produceBlock/`.

The import pipeline keeps the reference's separation: sanity checks →
state transition WITHOUT inline signature checks → ONE batched signature
verification over all sets of the segment (through the pluggable verifier
— TPU path) → fork-choice/cache/pool import.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from ..state_transition import CachedBeaconState, process_slots
from ..state_transition.block import get_attesting_indices
from ..state_transition.signature_sets import get_block_signature_sets
from ..state_transition.stf import state_transition
from ..state_transition import util as st_util
from ..fork_choice import ForkChoice, ForkChoiceStore, ProtoArray
from ..observability import spans as _spans
from .bls_verifier import IBlsVerifier
from .clock import BeaconClock, ManualClock
from .op_pools import (
    AggregatedAttestationPool,
    AttestationPool,
    BlsToExecutionChangePool,
    OpPool,
    SyncCommitteeMessagePool,
    SyncContributionAndProofPool,
)
from .seen_cache import (
    SeenAggregatedAttestations,
    SeenAggregators,
    SeenAttesters,
    SeenBlockProposers,
    SeenContributionAndProof,
    SeenSyncCommitteeMessages,
)
from .state_cache import CheckpointStateCache, StateContextCache

_log = logging.getLogger(__name__)


def _verify_now(verifier, sets) -> bool:
    """verify_signature_sets with batchable=False where the facade
    supports it (block/segment import must not wait out a gossip
    batching window).

    Support is detected from the signature (cached per underlying
    function, so instance-attribute overrides can't poison other
    instances of the class) — not by catching TypeError around the live
    call, which would swallow a genuine TypeError raised inside
    verification (malformed set contents) and silently re-run the whole
    batch. An explicit `batchable` parameter counts, and so does a
    `**kwargs` catch-all: a thin wrapper/decorator that
    forwards keyword arguments to a batching facade must receive
    batchable=False, not silently fall into the wait-window path."""
    fn = verifier.verify_signature_sets
    key = getattr(fn, "__func__", fn)
    supports = _VERIFY_NOW_SUPPORT.get(key)
    if supports is None:
        import inspect

        try:
            params = inspect.signature(fn).parameters
            supports = "batchable" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (ValueError, TypeError):  # builtins without signatures
            supports = False
        _VERIFY_NOW_SUPPORT[key] = supports
    if supports:
        return fn(sets, batchable=False)
    return fn(sets)


import weakref

_VERIFY_NOW_SUPPORT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class BlockImportError(ValueError):
    pass


IMPORT_WAIT_TIMEOUT_S = 300.0


def _bounded_result(fut, site: str, m=None, timeout: float | None = IMPORT_WAIT_TIMEOUT_S):
    """``fut.result()`` bounded by ``timeout`` seconds (the chain's
    ``import_wait_timeout_s``).

    Block/segment import must never pin the serving thread forever on a
    wedged future (a hung EL socket, a dead device worker): the wait is
    bounded (<= 0 disables the bound), and a timeout increments
    ``lodestar_chain_blocking_wait_timeouts_total{site=...}`` before
    failing the import with a clear error instead of hanging silently.
    """
    if timeout is not None and timeout <= 0:
        timeout = None
    try:
        return fut.result(timeout=timeout)
    except FuturesTimeout:
        if m is not None:
            m.blocking_wait_timeouts_total.inc(site=site)
        _log.error(
            "blocking wait at %s exceeded the import wait timeout "
            "(%.1fs) — escalating instead of hanging the import path",
            site, timeout,
        )
        raise BlockImportError(
            f"{site} wait exceeded the import wait timeout "
            f"({timeout:.1f}s); the verification backend may be wedged"
        ) from None


class BeaconChain:
    """Single-process chain service (the composition the reference builds
    in `chain.ts` ctor: verifier, clock, caches, pools, fork choice)."""

    def __init__(
        self,
        config,
        types,
        anchor_state,
        verifier: IBlsVerifier | None = None,
        clock: BeaconClock | None = None,
        db=None,
        execution_engine=None,
        device=None,
        import_wait_timeout_s: float = IMPORT_WAIT_TIMEOUT_S,
    ):
        self.config = config
        self.types = types
        self.preset = config.preset
        # with no verifier: the port's serving stack on `device` (the GPU
        # by default; raises without one), stopped by close()
        self.bls_stack = None
        if verifier is None:
            from ..node.bls_stack import build_bls_stack

            self.bls_stack = build_bls_stack(device)
            verifier = self.bls_stack.verifier
        self.bls = verifier
        self.import_wait_timeout_s = import_wait_timeout_s
        self.execution_engine = execution_engine
        # serializes chain mutation between the event loop (gossip) and
        # worker threads (range sync, REST) — see process_block
        self.import_lock = threading.RLock()
        # two helpers for the 3-way parallel block verification
        # (signatures ∥ payload, overlapping the host state transition)
        from concurrent.futures import ThreadPoolExecutor

        self._verify_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="blockverify"
        )
        # irrecoverable-fault escalation (reference ProcessShutdownCallback
        # + faultInspectionWindow/allowedFaults, chain.ts:121-123)
        self.process_shutdown_callback = None
        self.fault_inspection_window_slots = 32
        self.allowed_faults = 5
        self._fault_slots: list[int] = []

        cached = CachedBeaconState(config, anchor_state, self.preset)
        self.head_state = cached
        anchor_root = _anchor_block_root(anchor_state)
        self.genesis_time = anchor_state.genesis_time

        self.clock = clock if clock is not None else ManualClock(
            self.genesis_time, config.SECONDS_PER_SLOT, self.preset.SLOTS_PER_EPOCH
        )

        proto = ProtoArray(
            justified_epoch=anchor_state.current_justified_checkpoint.epoch,
            finalized_epoch=anchor_state.finalized_checkpoint.epoch,
            slots_per_epoch=self.preset.SLOTS_PER_EPOCH,
        )
        proto.on_block(
            anchor_state.slot,
            anchor_root,
            None,
            anchor_state.hash_tree_root(),
            anchor_state.current_justified_checkpoint.epoch,
            anchor_state.finalized_checkpoint.epoch,
        )
        store = ForkChoiceStore(
            current_slot=anchor_state.slot,
            justified_checkpoint=(
                anchor_state.current_justified_checkpoint.epoch,
                anchor_root,
            ),
            finalized_checkpoint=(
                anchor_state.finalized_checkpoint.epoch,
                anchor_root,
            ),
            justified_balances=cached.flat.effective_balance.astype(np.int64),
        )
        self.fork_choice = ForkChoice(
            store,
            proto,
            self.preset.SLOTS_PER_EPOCH,
            seconds_per_slot=config.SECONDS_PER_SLOT,
            proposer_score_boost=config.PROPOSER_SCORE_BOOST,
            safe_slots_to_update_justified=self.preset.SAFE_SLOTS_TO_UPDATE_JUSTIFIED,
            justified_balances_getter=self._justified_balances_for,
        )
        self.head_root = anchor_root

        self.state_cache = StateContextCache()
        self.checkpoint_state_cache = CheckpointStateCache()
        self.state_cache.add(
            anchor_state.hash_tree_root(), cached, block_root=anchor_root
        )

        self.attestation_pool = AttestationPool()
        self.aggregated_pool = AggregatedAttestationPool()
        self.op_pool = OpPool()
        self.sync_committee_pool = SyncCommitteeMessagePool(self.preset)
        self.sync_contribution_pool = SyncContributionAndProofPool(self.preset)
        self.bls_changes_pool = BlsToExecutionChangePool()
        self.seen_attesters = SeenAttesters()
        self.seen_aggregators = SeenAggregators()
        self.seen_block_proposers = SeenBlockProposers()
        self.seen_aggregated = SeenAggregatedAttestations()
        self.seen_sync_committee = SeenSyncCommitteeMessages()
        self.seen_contribution_and_proof = SeenContributionAndProof()
        self.blocks: dict[bytes, object] = {anchor_root: None}
        self.finalized_blocks: dict[bytes, object] = {}

        from ..db import BeaconDb
        from .archiver import Archiver
        from .regen import StateRegenerator

        self.db = db if db is not None else BeaconDb(types)
        self.regen = StateRegenerator(self)
        self.archiver = Archiver(self, self.db)

        # light-client server (altair+ blocks carry sync aggregates)
        from ..light_client import LightClientServer

        self.light_client_server = LightClientServer(config, types, self.preset)

        from .prepare_next_slot import PrepareNextSlotScheduler

        self.prepare_next_slot = PrepareNextSlotScheduler(self)

        from .proposer_cache import BeaconProposerCache

        self.beacon_proposer_cache = BeaconProposerCache()

        from .emitter import ChainEventEmitter

        self.emitter = ChainEventEmitter()

    def close(self) -> None:
        """Stop the verify pool, and the serving stack when the chain built
        it (a verifier the caller passed in is the caller's to stop)."""
        self._verify_pool.shutdown(wait=True)
        if self.bls_stack is not None:
            self.bls_stack.close()
            self.bls_stack = None

    def _bounded(self, fut, site: str, m=None):
        return _bounded_result(fut, site, m, self.import_wait_timeout_s)

    # -- block import (reference chain/blocks pipeline) ----------------------

    def process_block(self, signed_block, verify_signatures: bool = True):
        # one writer at a time: gossip handlers run on the event loop while
        # range sync imports from an executor thread — the import lock keeps
        # the state-transition + fork-choice update atomic per block
        with self.import_lock:
            return self._process_block_locked(signed_block, verify_signatures)

    def _process_block_locked(self, signed_block, verify_signatures: bool = True):
        block = signed_block.message
        block_root = block.hash_tree_root()
        # sanity checks (verifyBlocksSanityChecks)
        if block_root in self.blocks:
            return block_root  # already known
        parent_root = bytes(block.parent_root)
        if parent_root not in self.blocks:
            raise BlockImportError(f"unknown parent {parent_root.hex()}")
        finalized_slot = st_util.compute_start_slot_at_epoch(
            self.fork_choice.store.finalized_checkpoint[0],
            self.preset.SLOTS_PER_EPOCH,
        )
        if block.slot <= finalized_slot:
            raise BlockImportError("block slot not after finalized")

        # the lifecycle span: child of the gossip trace when one is
        # active, its own root trace on direct imports (REST publish,
        # unknown-block fetch) — either way one correlated trace per block
        with _spans.tracer.span(
            "chain/process_block",
            slot=int(block.slot),
            root=block_root.hex(),
        ):
            return self._process_block_spanned(
                signed_block, block_root, verify_signatures
            )

    def _process_block_spanned(
        self, signed_block, block_root: bytes, verify_signatures: bool
    ):
        block = signed_block.message
        # pre-state (advanced to the block's slot: its epoch context covers
        # the block's committees/proposer, so signature sets can be built
        # BEFORE the state transition — the key to the 3-way overlap)
        with _spans.tracer.span("chain/pre_state"):
            pre = self._get_pre_state(signed_block)

        # 3-way parallel verification (reference verifyBlock.ts:69-80:
        # state transition ∥ BLS signatures ∥ execution payload). The
        # signature batch releases the GIL in the native marshal + device
        # dispatch, and the payload check blocks on the EL's HTTP reply,
        # so both genuinely overlap the pure-Python state transition.
        import time as _time

        m = getattr(self, "metrics", None)
        fut_sig = fut_payload = None
        t_start = _time.monotonic()
        # worker threads don't inherit contextvars: hand them the live span
        trace_ctx = _spans.tracer.context()
        if verify_signatures:
            sets = get_block_signature_sets(pre, self.types, signed_block)
            # block import is latency-critical: verify immediately rather
            # than sitting in a batching facade's wait window
            fut_sig = self._verify_pool.submit(
                self._verify_now_traced, trace_ctx, sets
            )
        fut_payload = self._verify_pool.submit(
            self._verify_execution_payload_traced, trace_ctx, pre, signed_block
        )

        try:
            post = pre.copy()
            with _spans.tracer.span("chain/state_transition"):
                state_transition(
                    post, self.types, signed_block,
                    verify_state_root=True, verify_signatures=False,
                )
            t_stf = _time.monotonic()
            if m is not None:
                m.block_stf_seconds.observe(t_stf - t_start)
            if fut_sig is not None and not self._bounded(fut_sig, "block_signature", m):
                if m is not None:
                    m.block_import_errors_total.inc(reason="signature")
                raise BlockImportError("block signature set verification failed")
            if fut_sig is not None:
                self._record_milestone("sigs_verified", block.slot)
            t_sig = _time.monotonic()
            if m is not None and fut_sig is not None:
                # wait beyond the STF, i.e. the non-overlapped signature tail
                m.block_sig_seconds.observe(t_sig - t_stf)
            # raises on INVALID; bounded so a hung EL can't wedge imports
            payload_status = self._bounded(fut_payload, "block_payload", m)
            if m is not None:
                m.block_payload_seconds.observe(_time.monotonic() - t_sig)
                m.block_import_seconds.observe(_time.monotonic() - t_start)
                m.processed_blocks_total.inc()
        except BaseException:
            # never abandon in-flight work: an orphaned payload check
            # would pin a pool worker on the EL's HTTP timeout and
            # serialize the NEXT import behind it
            for fut in (fut_sig, fut_payload):
                if fut is not None:
                    try:
                        self._bounded(fut, "block_drain", m)
                    except Exception as drained:
                        _log.debug("drained parallel import future: %s", drained)
            raise

        self._import_block(signed_block, block_root, post, payload_status)
        return block_root

    def _verify_now_traced(self, trace_ctx, sets) -> bool:
        """_verify_now on a pool worker, attached to the caller's trace so
        the signature batch appears as a `chain/bls_verify` span."""
        with _spans.tracer.attach(trace_ctx), _spans.tracer.span(
            "chain/bls_verify", sets=len(sets)
        ):
            return _verify_now(self.bls, sets)

    def _verify_execution_payload_traced(self, trace_ctx, pre, signed_block):
        with _spans.tracer.attach(trace_ctx), _spans.tracer.span(
            "chain/execution_payload"
        ):
            return self._verify_execution_payload(pre, signed_block)

    def _record_milestone(self, milestone: str, slot) -> None:
        """Slot-milestone delay, recorded only for blocks of the CURRENT
        clock slot: range-sync imports of historic blocks would flood the
        histogram's +Inf bucket with hours-old 'delays' and bury the
        live-following signal the metric exists for."""
        if int(slot) == self.clock.current_slot:
            _spans.record_slot_milestone(self, milestone, slot)

    def process_block_segment(self, signed_blocks, verify_signatures: bool = True):
        """Import a range-sync segment with ONE batched signature dispatch.

        Reference shape (verifyBlocksInEpoch + verifyBlocksSignatures:
        ~8,000 signatures per 64-block mainnet segment verified as one
        batch, multithread/index.ts:34): pass 1 rolls the state forward —
        with the same sanity guards as the per-block path — collecting
        every block's signature sets while the execution payloads verify
        on the pool; the whole segment's sets then go to the verifier as
        one call; pass 2 imports.

        Atomicity: a pass-1/verification failure imports NOTHING. A
        pass-2 failure (a block that passed STF but breaks fork-choice
        import) leaves the verified prefix imported; the caller's
        re-download then skips those via the known-root check.
        """
        with self.import_lock:
            return self._process_segment_locked(signed_blocks, verify_signatures)

    def _process_segment_locked(self, signed_blocks, verify_signatures: bool):
        signed_blocks = list(signed_blocks)
        with _spans.tracer.span(
            "chain/process_segment", blocks=len(signed_blocks)
        ):
            return self._process_segment_spanned(
                signed_blocks, verify_signatures
            )

    def _process_segment_spanned(self, signed_blocks, verify_signatures: bool):
        import time as _time

        m = getattr(self, "metrics", None)
        pending = []
        all_sets: list = []
        set_slots: list[int] = []  # signing block's slot, parallel to all_sets
        state = None
        finalized_slot = st_util.compute_start_slot_at_epoch(
            self.fork_choice.store.finalized_checkpoint[0],
            self.preset.SLOTS_PER_EPOCH,
        )
        for signed in signed_blocks:
            block = signed.message
            root = block.hash_tree_root()
            # the per-block path's sanity checks (verifyBlocksSanityChecks)
            if root in self.blocks:
                state = None  # next block re-resolves its pre-state
                continue
            if block.slot <= finalized_slot:
                raise BlockImportError("segment block slot not after finalized")
            if state is None and bytes(block.parent_root) not in self.blocks:
                raise BlockImportError(
                    f"unknown parent {bytes(block.parent_root).hex()}"
                )
            if state is None:
                pre = self._get_pre_state(signed)
            else:
                pre = state
                if block.slot > pre.state.slot:
                    process_slots(pre, self.types, block.slot)
            if verify_signatures:
                block_sets = get_block_signature_sets(pre, self.types, signed)
                all_sets.extend(block_sets)
                set_slots.extend([int(block.slot)] * len(block_sets))
            # payload verification overlaps the NEXT block's STF (the
            # per-block path's 3-way overlap, segment-shaped)
            fut_payload = self._verify_pool.submit(
                self._verify_execution_payload, pre, signed
            )
            t0 = _time.monotonic()
            post = pre.copy()
            with _spans.tracer.span(
                "chain/state_transition", slot=int(block.slot)
            ):
                state_transition(
                    post, self.types, signed,
                    verify_state_root=True, verify_signatures=False,
                )
            if m is not None:
                m.block_stf_seconds.observe(_time.monotonic() - t0)
            pending.append((signed, root, post, fut_payload))
            state = post.copy()

        try:
            if verify_signatures and all_sets:
                t0 = _time.monotonic()
                with _spans.tracer.span("chain/bls_verify", sets=len(all_sets)):
                    batch_ok = _verify_now(self.bls, all_sets)
                if not batch_ok:
                    if m is not None:
                        m.block_import_errors_total.inc(reason="signature")
                    # bisection verdicts make pinpointing cheap (O(k·log N)
                    # final exps on the device tier), so name the offending
                    # block instead of failing the whole segment opaquely —
                    # the caller's re-download/peer-scoring can act on it
                    detail = ""
                    pinpoint = getattr(
                        self.bls, "verify_signature_sets_individual", None
                    )
                    if callable(pinpoint):
                        try:
                            with _spans.tracer.span(
                                "chain/bls_pinpoint", sets=len(all_sets)
                            ):
                                verdicts = pinpoint(all_sets)
                            bad_slots = sorted(
                                {
                                    set_slots[i]
                                    for i, ok in enumerate(verdicts)
                                    if not ok
                                }
                            )
                            if bad_slots:
                                detail = (
                                    f" (invalid signature in block(s) at "
                                    f"slot(s) {bad_slots})"
                                )
                        except Exception as e:
                            # pinpointing is best-effort diagnostics
                            _log.debug("bisect pinpointing failed: %s", e)
                    raise BlockImportError(
                        "segment signature batch failed" + detail
                    )
                if pending:
                    self._record_milestone(
                        "sigs_verified", pending[-1][0].message.slot
                    )
                if m is not None:
                    m.block_sig_seconds.observe(_time.monotonic() - t0)
        except BaseException:
            for _, _, _, fut in pending:
                try:
                    self._bounded(fut, "segment_drain", m)
                except Exception as drained:
                    _log.debug("drained segment payload future: %s", drained)
            raise

        roots = []
        for signed, root, post, fut_payload in pending:
            try:
                payload_status = self._bounded(fut_payload, "segment_payload", m)
            except BaseException:
                if m is not None:
                    m.block_import_errors_total.inc(reason="payload")
                for _, _, _, f in pending:
                    if not f.done():
                        try:
                            self._bounded(f, "segment_drain", m)
                        except Exception as drained:
                            _log.debug(
                                "drained segment payload future: %s", drained
                            )
                raise
            t0 = _time.monotonic()
            self._import_block(signed, root, post, payload_status)
            if m is not None:
                m.block_import_seconds.observe(_time.monotonic() - t0)
                m.processed_blocks_total.inc()
            roots.append(root)
        return roots

    def _verify_execution_payload(self, post, signed_block):
        """Returns the engine status (None = nothing to verify) so the
        import records the right optimistic execution_status."""
        if self.execution_engine is None or not post.is_execution:
            return None
        from ..execution.engine import ExecutePayloadStatus
        from ..state_transition.bellatrix import has_execution_payload

        body = signed_block.message.body
        if not has_execution_payload(body):
            return None  # pre-merge empty payload: nothing for the EL
        status = self.execution_engine.notify_new_payload(body.execution_payload)
        if status in (ExecutePayloadStatus.INVALID, ExecutePayloadStatus.INVALID_BLOCK_HASH):
            # optimistic-sync invalidation: with a RESOLVABLE
            # latestValidHash, ancestors after the LVH block (and their
            # descendants) become non-viable (reference LVH walk —
            # round-1 VERDICT fork-choice gap). An unresolvable LVH
            # invalidates NOTHING extra: the offending block was never
            # imported, and guessing would brick a valid head.
            lvh = getattr(self.execution_engine, "last_latest_valid_hash", None)
            lvh_root = self._block_root_of_payload(lvh) if lvh else None
            if lvh_root is not None:
                parent_root = bytes(signed_block.message.parent_root)
                invalidated = self.fork_choice.proto.invalidate_payloads(
                    parent_root, lvh_root
                )
                if invalidated:
                    _log.warning(
                        "engine INVALID invalidated %d optimistic ancestors",
                        len(invalidated),
                    )
            raise BlockImportError(f"execution payload invalid: {status}")
        return status

    def _block_root_of_payload(self, block_hash: bytes) -> bytes | None:
        """Beacon block root whose payload has `block_hash` (walks the hot
        blocks; None when unknown — then only the offending head is
        invalidated)."""
        for root, signed in self.blocks.items():
            if signed is None:
                continue
            body = signed.message.body
            payload = getattr(body, "execution_payload", None)
            if payload is not None and bytes(payload.block_hash) == block_hash:
                return root
        return None

    def _justified_balances_for(self, checkpoint):
        """Effective balances of the checkpoint's OWN state for fork-choice
        adoption (reference justifiedBalancesGetter, forkChoice.ts:129):
        resolved from the checkpoint-state cache; None lets fork choice
        keep its fallback (the importing block's balances)."""
        epoch, root = checkpoint
        cached = self.checkpoint_state_cache.get(epoch, root)
        if cached is None:
            return None
        return cached.flat.effective_balance.astype(np.int64)

    def _get_pre_state(self, signed_block) -> CachedBeaconState:
        """Pre-state via regen: cache fast path, replay fallback
        (reference: regen.getPreState from the BlockProcessor)."""
        from .regen import RegenError

        try:
            return self.regen.get_pre_state(signed_block.message)
        except RegenError as e:
            raise BlockImportError(str(e)) from e

    def _import_block(
        self, signed_block, block_root: bytes, post, payload_status=None
    ) -> None:
        with _spans.tracer.span(
            "chain/import",
            slot=int(signed_block.message.slot),
            root=block_root.hex(),
        ):
            self._import_block_spanned(
                signed_block, block_root, post, payload_status
            )

    def _import_block_spanned(
        self, signed_block, block_root: bytes, post, payload_status=None
    ) -> None:
        block = signed_block.message
        state = post.state
        prev_finalized = self.fork_choice.store.finalized_checkpoint[0]
        # timeliness for the proposer boost: seconds since the block's
        # slot started, at import time
        block_delay = self.clock.time_fn() - self.clock.time_at_slot(block.slot)
        with _spans.tracer.span("chain/fork_choice"):
            self.fork_choice.update_time(
                max(self.clock.current_slot, block.slot)
            )
            # unrealized checkpoints: what FFG would reach if the epoch
            # ended now — feeds tip pull-up + prior-epoch viability
            # (reference forkChoice.ts:406-453)
            try:
                from ..state_transition.unrealized import (
                    compute_unrealized_checkpoints,
                )

                unrealized_j, unrealized_f = compute_unrealized_checkpoints(
                    post, self.types
                )
            except Exception:
                # degrading to realized checkpoints keeps import alive, but
                # silently losing pull-up would be undiagnosable — log it
                import logging

                logging.getLogger(__name__).exception(
                    "compute_unrealized_checkpoints failed; using realized"
                )
                unrealized_j = unrealized_f = None
            self.fork_choice.on_block(
                block.slot,
                block_root,
                bytes(block.parent_root),
                bytes(block.state_root),
                (
                    state.current_justified_checkpoint.epoch,
                    bytes(state.current_justified_checkpoint.root),
                ),
                (
                    state.finalized_checkpoint.epoch,
                    bytes(state.finalized_checkpoint.root),
                ),
                justified_balances=post.flat.effective_balance.astype(np.int64),
                unrealized_justified_checkpoint=unrealized_j,
                unrealized_finalized_checkpoint=unrealized_f,
                block_delay_sec=block_delay,
                execution_status=_exec_status_for_fork_choice(
                    payload_status, post
                ),
            )
            if payload_status is not None and str(
                getattr(payload_status, "value", payload_status)
            ) == "VALID":
                # a VALID verdict confirms every optimistic ancestor too
                self.fork_choice.proto.set_execution_valid(block_root)
            # per-attestation fork-choice votes (importBlock.ts:88-130)
            monitor = getattr(self, "validator_monitor", None)
            monitored = monitor.monitored if monitor is not None else set()
            for att in block.body.attestations:
                try:
                    indices = get_attesting_indices(
                        post, att.data, att.aggregation_bits
                    )
                    self.fork_choice.on_attestation(
                        indices,
                        bytes(att.data.beacon_block_root),
                        att.data.target.epoch,
                    )
                    if monitored and monitored.intersection(
                        int(i) for i in indices
                    ):
                        spe = self.preset.SLOTS_PER_EPOCH
                        target_root = self.fork_choice.get_ancestor(
                            block_root, int(att.data.target.epoch) * spe
                        )
                        head_at_slot = self.fork_choice.get_ancestor(
                            block_root, int(att.data.slot)
                        )
                        monitor.on_attestation_included(
                            int(att.data.target.epoch),
                            indices,
                            int(block.slot) - int(att.data.slot),
                            target_correct=target_root
                            == bytes(att.data.target.root),
                            head_correct=head_at_slot
                            == bytes(att.data.beacon_block_root),
                        )
                except Exception as e:
                    _log.debug(
                        "validator-monitor inclusion accounting failed: %s", e
                    )
                    continue
        if monitored:
            epoch = int(block.slot) // self.preset.SLOTS_PER_EPOCH
            monitor.on_block_proposed(
                epoch, int(block.proposer_index), delay_sec=block_delay
            )
            agg = getattr(block.body, "sync_aggregate", None)
            if agg is not None:
                pk_to_idx = post.epoch_ctx.pubkey_to_index
                included = [
                    pk_to_idx.get(bytes(pk), -1)
                    for pk, bit in zip(
                        post.state.current_sync_committee.pubkeys,
                        list(agg.sync_committee_bits),
                    )
                    if bit
                ] if hasattr(post.state, "current_sync_committee") else []
                if included:
                    monitor.on_sync_signature_included(epoch, included)
        # light-client data: the sync aggregate in this block signs its
        # parent (reference: lightClientServer.onImportBlockHead)
        if hasattr(block.body, "sync_aggregate"):
            parent_root = bytes(block.parent_root)
            parent_block = self.blocks.get(parent_root)
            parent_state = self.state_cache.get_by_block_root(parent_root)
            if parent_block is not None and parent_state is not None:
                try:
                    self.light_client_server.on_import_block(
                        signed_block, parent_block, parent_state
                    )
                    self._emit_light_client_updates()
                except Exception as e:
                    # light-client data is best-effort, never blocks import
                    _log.debug("light-client server on_import_block failed: %s", e)
        self.blocks[block_root] = signed_block
        self.db.block.put(block_root, signed_block)
        self.state_cache.add(state.hash_tree_root(), post, block_root=block_root)
        self.seen_block_proposers.add(block.slot, block.proposer_index)
        self._record_milestone("imported", block.slot)
        prev_head = self.head_root
        self.head_state = post
        with _spans.tracer.span("chain/head_update"):
            self.update_head()
            self._notify_forkchoice_to_engine()
        from .emitter import ChainEvent

        self.emitter.emit(
            ChainEvent.block,
            {"slot": str(int(block.slot)), "block": "0x" + block_root.hex()},
        )
        if self.head_root != prev_head:
            self._record_milestone("head_updated", block.slot)
            # block.state_root is the imported state's verified root — no
            # re-merkleization on the import hot path
            state_root = (
                bytes(block.state_root)
                if self.head_root == block_root
                else self.head_state.state.latest_block_header.state_root
            )
            self.emitter.emit(
                ChainEvent.head,
                {
                    "slot": str(int(self.head_state.state.slot)),
                    "block": "0x" + self.head_root.hex(),
                    "state": "0x" + bytes(state_root).hex(),
                },
            )
        # prune + archive on finalization advance
        fin_epoch = self.fork_choice.store.finalized_checkpoint[0]
        if fin_epoch > prev_finalized:
            self.seen_attesters.prune(fin_epoch)
            self.seen_aggregators.prune(fin_epoch)
            self.seen_aggregated.prune(fin_epoch)
            self.checkpoint_state_cache.prune_finalized(fin_epoch)
            self.archiver.process_finalized()
            self.bls_changes_pool.prune(post)
            fin_root = self.fork_choice.store.finalized_checkpoint[1]
            self.emitter.emit(
                ChainEvent.finalized_checkpoint,
                {"epoch": str(fin_epoch), "block": "0x" + fin_root.hex()},
            )
        self.aggregated_pool.prune(post.current_epoch)
        self.sync_committee_pool.prune(block.slot)
        self.sync_contribution_pool.prune(block.slot)
        self.seen_sync_committee.prune(block.slot)
        self.seen_contribution_and_proof.prune(block.slot)
        self.beacon_proposer_cache.prune(post.current_epoch)

    def _emit_light_client_updates(self) -> None:
        """SSE light-client events after import (reference events.ts
        light_client_optimistic_update / finality_update topics)."""
        from .emitter import ChainEvent

        lc = self.light_client_server
        optimistic = getattr(lc, "latest_optimistic_update", None)
        if optimistic is not None:
            self.emitter.emit(
                ChainEvent.lightclient_optimistic_update, optimistic.to_obj()
            )
        finality = getattr(lc, "latest_finality_update", None)
        if finality is not None:
            self.emitter.emit(
                ChainEvent.lightclient_finality_update, finality.to_obj()
            )

    def update_head(self) -> bytes:
        try:
            self.head_root = self.fork_choice.update_head()
        except Exception:
            # fork-choice head selection failing is the reference's
            # irrecoverable class (chain.ts:121-123): count it against
            # the fault window and escalate to process shutdown when the
            # budget is spent — a node that cannot pick a head must not
            # keep attesting on a stale one
            self._register_irrecoverable_fault()
            raise
        head_state = self.state_cache.get_by_block_root(self.head_root)
        if head_state is not None:
            self.head_state = head_state
        return self.head_root

    def _register_irrecoverable_fault(self) -> None:
        """faultInspectionWindow/allowedFaults semantics (reference
        BeaconChain opts + ProcessShutdownCallback): more than
        ALLOWED_FAULTS head-selection failures within the sliding
        FAULT_INSPECTION_WINDOW_SLOTS triggers the shutdown callback
        (wired by the CLI to stop the process)."""
        now_slot = self.clock.current_slot
        window = self.fault_inspection_window_slots
        allowed = self.allowed_faults
        self._fault_slots.append(now_slot)
        self._fault_slots = [s for s in self._fault_slots if s >= now_slot - window]
        cb = self.process_shutdown_callback
        if cb is not None and len(self._fault_slots) > allowed:
            import logging

            logging.getLogger(__name__).critical(
                "%d fork-choice faults within %d slots: requesting shutdown",
                len(self._fault_slots), window,
            )
            cb("irrecoverable fork-choice errors")

    def _notify_forkchoice_to_engine(self) -> None:
        """Mirror the beacon head/finalized into the EL (reference:
        engine_forkchoiceUpdated on head change, importBlock.ts)."""
        if self.execution_engine is None or not self.head_state.is_execution:
            return
        from ..state_transition.bellatrix import is_merge_transition_complete

        state = self.head_state.state
        if not is_merge_transition_complete(state):
            return
        head_hash = bytes(state.latest_execution_payload_header.block_hash)
        fin_root = self.fork_choice.store.finalized_checkpoint[1]
        fin_state = self.state_cache.get_by_block_root(fin_root)
        fin_hash = (
            bytes(fin_state.state.latest_execution_payload_header.block_hash)
            if fin_state is not None and fin_state.is_execution
            else b"\x00" * 32
        )
        try:
            self.execution_engine.notify_forkchoice_update(head_hash, head_hash, fin_hash)
        except Exception as e:
            # EL sync is advisory for the beacon side
            _log.debug("forkchoiceUpdated notification failed: %s", e)

    # -- attestation intake (gossip path) ------------------------------------

    def on_gossip_attestation(self, attestation, data_root: bytes) -> None:
        with self.import_lock:
            outcome = self.attestation_pool.add(attestation, data_root)
        m = getattr(self, "metrics", None)
        if m is not None:
            m.attestation_pool_inserts_total.inc(outcome=str(outcome))
        monitor = getattr(self, "validator_monitor", None)
        if monitor is not None and monitor.monitored:
            try:
                indices = get_attesting_indices(
                    self.head_state, attestation.data, attestation.aggregation_bits
                )
                delay = self.clock.time_fn() - self.clock.time_at_slot(
                    int(attestation.data.slot)
                )
                for idx in indices:
                    monitor.on_gossip_attestation(
                        int(attestation.data.target.epoch), int(idx), delay
                    )
            except Exception as e:
                _log.debug("validator-monitor gossip accounting failed: %s", e)

    def on_aggregated_attestation(self, attestation, data_root: bytes) -> None:
        with self.import_lock:
            self._on_aggregated_attestation_locked(attestation, data_root)

    def _on_aggregated_attestation_locked(self, attestation, data_root: bytes) -> None:
        self.aggregated_pool.add(attestation, data_root)
        try:
            state = self.head_state
            indices = get_attesting_indices(
                state, attestation.data, attestation.aggregation_bits
            )
            self.fork_choice.update_time(self.clock.current_slot)
            self.fork_choice.on_attestation(
                indices,
                bytes(attestation.data.beacon_block_root),
                attestation.data.target.epoch,
            )
            monitor = getattr(self, "validator_monitor", None)
            if monitor is not None and monitor.monitored:
                monitor.on_attestation_in_aggregate(
                    int(attestation.data.target.epoch), indices
                )
        except Exception as e:
            # aggregate fork-choice accounting is advisory; the pool add
            # above already succeeded
            _log.debug("aggregated-attestation accounting failed: %s", e)

    # -- block production (chain/produceBlock) -------------------------------

    def produce_block(
        self,
        slot: int,
        randao_reveal: bytes,
        graffiti: bytes = b"",
        fee_recipient: bytes | None = None,
    ):
        """Assemble an unsigned block on the current head (reference
        produceBlock/produceBlockBody: pools → ops, eth1 vote, sync
        aggregate, execution payload via engine, state root)."""
        from ..state_transition.stf import fork_types

        prepared = self.prepare_next_slot.get_prepared(slot, self.head_root)
        if prepared is not None:
            pre = prepared.copy()
        else:
            pre = self.head_state.copy()
            if slot > pre.state.slot:
                process_slots(pre, self.types, slot)
        types = fork_types(pre)
        parent_root = pre.state.latest_block_header.hash_tree_root()
        proposer = pre.epoch_ctx.get_beacon_proposer(slot)
        if fee_recipient is None:
            # fall back to the proposer's prepareBeaconProposer registration
            fee_recipient = self.beacon_proposer_cache.get(proposer)
        attestations = self.aggregated_pool.get_attestations_for_block(
            types, pre, self.preset.MAX_ATTESTATIONS
        )
        prop_slash, att_slash, exits = self.op_pool.get_slashings_and_exits(
            pre, self.preset
        )
        # eth1 vote + pending deposits via the tracker when one is wired
        # (node opts.eth1_provider; reference produceBlockBody eth1 data
        # vote + deposits from the eth1 cache)
        tracker = getattr(self, "eth1_tracker", None)
        eth1_data = pre.state.eth1_data.copy()
        deposits = []
        if tracker is not None:
            # READ-only here: following (log catch-up over JSON-RPC) runs
            # on the node's slot cadence in the background — a historical
            # sync inline would blow the proposal deadline
            try:
                eth1_data = tracker.get_eth1_vote(
                    pre.state, int(self.clock.time_fn())
                )
                deposits = tracker.get_deposits_for_block(pre.state)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "eth1 tracker failed; producing without deposits"
                )
                eth1_data = pre.state.eth1_data.copy()
                deposits = []
        body = types.BeaconBlockBody(
            randao_reveal=randao_reveal,
            eth1_data=eth1_data,
            graffiti=graffiti.ljust(32, b"\x00")[:32],
            proposer_slashings=[s.copy() for s in prop_slash],
            attester_slashings=[s.copy() for s in att_slash],
            attestations=attestations,
            deposits=deposits,
            voluntary_exits=[e.copy() for e in exits],
        )
        if hasattr(body, "sync_aggregate"):
            # the block's sync aggregate signs the parent (previous slot root)
            body.sync_aggregate = self.sync_contribution_pool.get_sync_aggregate(
                types, max(slot, 1) - 1, parent_root
            )
        if pre.is_execution:
            payload = self._produce_execution_payload(pre, types, fee_recipient)
            if payload is not None:
                body.execution_payload = payload
        if pre.is_capella:
            body.bls_to_execution_changes = [
                c.copy() for c in self.bls_changes_pool.get_for_block(pre, self.preset)
            ]
        block = types.BeaconBlock(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=body,
        )
        trial = pre.copy()
        state_transition(
            trial,
            types,
            types.SignedBeaconBlock(message=block.copy(), signature=b"\x00" * 96),
            verify_state_root=False,
            verify_signatures=False,
        )
        block.state_root = trial.state.hash_tree_root()
        return block

    def _produce_execution_payload(self, pre, types, fee_recipient: bytes):
        """Build the payload through the engine (reference
        prepareExecutionPayload → engine.getPayload). Pre-merge (default
        header, no engine building) → None, leaving the default payload."""
        if self.execution_engine is None:
            return None
        prepared = build_payload_attributes(self.config, pre, types, fee_recipient)
        if prepared is None:
            return None  # pre-merge: empty payload until the EL offers one
        parent_hash, attributes = prepared
        payload_id = self.execution_engine.notify_forkchoice_update(
            parent_hash, parent_hash, parent_hash, attributes
        )
        if payload_id is None:
            return None
        fork = "capella" if pre.is_capella else "bellatrix"
        built = self.execution_engine.get_payload(payload_id, fork=fork)

        # engines return either a _MockPayload-like object (snake_case
        # attributes) or engine-API JSON (camelCase, hex quantities)
        from ..execution.engine import engine_json_field

        def got(name, default=None):
            return engine_json_field(built, name, default)

        fields = dict(
            parent_hash=_as_bytes(got("parent_hash", b"\x00" * 32)),
            fee_recipient=_as_bytes(got("fee_recipient", fee_recipient)),
            state_root=_as_bytes(got("state_root", b"\x00" * 32)),
            receipts_root=_as_bytes(got("receipts_root", b"\x00" * 32)),
            logs_bloom=_as_bytes(got("logs_bloom", b"\x00" * 256)),
            prev_randao=_as_bytes(got("prev_randao", attributes.prev_randao)),
            block_number=_as_int(got("block_number", 0)),
            gas_limit=_as_int(got("gas_limit", 30_000_000)),
            gas_used=_as_int(got("gas_used", 0)),
            timestamp=_as_int(got("timestamp", attributes.timestamp)),
            extra_data=_as_bytes(got("extra_data", b"")),
            base_fee_per_gas=_as_int(got("base_fee_per_gas", 7)),
            block_hash=_as_bytes(got("block_hash", b"\x00" * 32)),
            transactions=[_as_bytes(tx) for tx in got("transactions", []) or []],
        )
        if pre.is_capella:
            fields["withdrawals"] = [
                _as_withdrawal(types, w) for w in got("withdrawals", []) or []
            ]
        return types.ExecutionPayload(**fields)

    @property
    def finalized_checkpoint(self):
        return self.fork_choice.store.finalized_checkpoint

    @property
    def justified_checkpoint(self):
        return self.fork_choice.store.justified_checkpoint


def build_payload_attributes(config, pre, types, fee_recipient: bytes = b"\x00" * 20):
    """(parent_hash, PayloadAttributes) for building the next payload on
    `pre`'s head, or None pre-merge. Shared by produce_block and the
    prepare-next-slot scheduler (reference: prepareExecutionPayload)."""
    from ..execution.engine import PayloadAttributes
    from ..state_transition.bellatrix import (
        compute_timestamp_at_slot,
        get_randao_mix,
        is_merge_transition_complete,
    )

    state = pre.state
    if not is_merge_transition_complete(state):
        return None
    withdrawals = []
    if pre.is_capella:
        from ..state_transition.capella import get_expected_withdrawals

        withdrawals = get_expected_withdrawals(pre, types)
    attributes = PayloadAttributes(
        timestamp=compute_timestamp_at_slot(config, state),
        prev_randao=get_randao_mix(state, pre.current_epoch, pre.preset),
        suggested_fee_recipient=fee_recipient,
        withdrawals=withdrawals,
    )
    return bytes(state.latest_execution_payload_header.block_hash), attributes


def _as_bytes(value) -> bytes:
    """Engine JSON uses 0x-hex strings; mocks use bytes."""
    if isinstance(value, str):
        return bytes.fromhex(value[2:] if value.startswith("0x") else value)
    return bytes(value)


def _as_int(value) -> int:
    """Engine JSON uses hex-quantity strings ("0x1"); mocks use ints."""
    if isinstance(value, str):
        return int(value, 16) if value.startswith("0x") else int(value)
    return int(value)


def _as_withdrawal(types, w):
    """Engine JSON withdrawal dict (camelCase hex) or an SSZ Withdrawal."""
    if isinstance(w, dict):
        return types.Withdrawal(
            index=_as_int(w.get("index", 0)),
            validator_index=_as_int(w.get("validatorIndex", w.get("validator_index", 0))),
            address=_as_bytes(w.get("address", b"\x00" * 20)),
            amount=_as_int(w.get("amount", 0)),
        )
    return w


def _exec_status_for_fork_choice(payload_status, post) -> str:
    """Engine verdict → proto-array execution_status (reference
    getPostMergeExecStatus: VALID→valid, SYNCING/ACCEPTED→syncing
    [optimistic import], no payload→pre_merge)."""
    if payload_status is None or not post.is_execution:
        return "pre_merge"
    v = str(getattr(payload_status, "value", payload_status))
    return "valid" if v == "VALID" else "syncing"


def _anchor_block_root(state) -> bytes:
    hdr = state.latest_block_header.copy()
    if hdr.state_root == b"\x00" * 32:
        hdr.state_root = state.hash_tree_root()
    return hdr.hash_tree_root()


