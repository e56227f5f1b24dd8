"""Range sync: download epoch batches from peers, import sequentially.

Reference: `sync/range/` — `SyncChain` (chain.ts:82) holds a window of
`SyncBatch`es in a state machine (AwaitingDownload → Downloading →
AwaitingProcessing → Processing → AwaitingValidation), downloads from many
peers concurrently with a peer balancer (`utils/peerBalancer.ts`), imports
in order, retries failed batches with rotated peers (`batch.ts`).

This implementation keeps the batch state machine and peer rotation, and
overlaps download with import: a bounded window of
batches downloads concurrently on a thread pool (network I/O releases
the GIL; the reference keeps ~`batchBuffer` batches in flight the same
way, `sync/range/chain.ts:82`) while the import side consumes strictly
in order — so the device verifier is never idle waiting on the wire, and
the wire never waits on a long segment import."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from .peer import IPeer, PeerError

EPOCHS_PER_BATCH = 2
MAX_BATCH_RETRIES = 5
DOWNLOAD_WINDOW = 4  # batches in flight ahead of the import cursor
# (reference: SyncChain keeps batchBuffer=5 epochs of batches downloading
# while processing sequentially — sync/range/chain.ts)


class BatchStatus(str, Enum):
    AWAITING_DOWNLOAD = "AwaitingDownload"
    DOWNLOADING = "Downloading"
    AWAITING_PROCESSING = "AwaitingProcessing"
    PROCESSING = "Processing"
    PROCESSED = "Processed"
    FAILED = "Failed"


@dataclass
class SyncBatch:
    start_slot: int
    count: int
    status: BatchStatus = BatchStatus.AWAITING_DOWNLOAD
    blocks: list = field(default_factory=list)
    failed_attempts: int = 0
    failed_peers: set[str] = field(default_factory=set)
    rr_offset: int = 0  # spreads concurrent first attempts over peers


class RangeSyncError(Exception):
    pass


class RangeSync:
    def __init__(
        self, chain, types, slots_per_epoch: int, verify_signatures: bool = True,
        metrics=None, download_window: int = DOWNLOAD_WINDOW,
        epochs_per_batch: int = EPOCHS_PER_BATCH,
    ):
        self.chain = chain
        self.types = types
        self.spe = slots_per_epoch
        self.verify_signatures = verify_signatures
        self.peers: list[IPeer] = []
        self.metrics = metrics
        self.download_window = max(1, download_window)
        self.epochs_per_batch = max(1, epochs_per_batch)

    def _export_batch_states(self, batches) -> None:
        if self.metrics is None:
            return
        counts: dict[str, int] = {s.value: 0 for s in BatchStatus}
        for b in batches:
            counts[b.status.value] = counts.get(b.status.value, 0) + 1
        for state, n in counts.items():
            self.metrics.sync_batches_in_state.set(n, state=state)

    def add_peer(self, peer: IPeer) -> None:
        self.peers.append(peer)

    # -- peer balancer (reference utils/peerBalancer.ts) ---------------------

    def _pick_peer(self, batch: SyncBatch) -> IPeer:
        candidates = [p for p in self.peers if p.peer_id not in batch.failed_peers]
        if not candidates:
            candidates = self.peers
        if not candidates:
            raise RangeSyncError("no peers")
        # rotate by attempt count (every retry lands on a DIFFERENT peer —
        # deterministic, so two peers always alternate) offset by the
        # batch's fixed index (concurrent window batches spread over the
        # peer set instead of piling on peers[0] — the reference's
        # peerBalancer assigns idle peers first)
        return candidates[(batch.failed_attempts + batch.rr_offset) % len(candidates)]

    # -- driving -------------------------------------------------------------

    def sync_to(self, target_slot: int) -> int:
        """Sync the canonical chain up to `target_slot`; returns head slot.

        Builds the batch window, downloads each batch (with retries and
        peer rotation), processes in order — one round-trip of the
        reference's state machine per batch."""
        head_slot = self.chain.head_state.state.slot
        batch_span = self.epochs_per_batch * self.spe
        batches: list[SyncBatch] = []
        start = head_slot + 1
        while start <= target_slot:
            count = min(batch_span, target_slot - start + 1)
            batches.append(
                SyncBatch(start_slot=start, count=count, rr_offset=len(batches))
            )
            start += count

        if not batches:
            return head_slot

        from concurrent.futures import ThreadPoolExecutor

        window = self.download_window
        with ThreadPoolExecutor(
            max_workers=window, thread_name_prefix="range-dl"
        ) as pool:
            futures: dict[int, object] = {}

            def top_up(cursor: int) -> None:
                hi = min(len(batches), cursor + window)
                for j in range(cursor, hi):
                    if j not in futures:
                        futures[j] = pool.submit(self._download, batches[j])

            for i, batch in enumerate(batches):
                top_up(i)
                self._export_batch_states(batches)
                futures.pop(i).result()  # raises if download exhausted retries
                top_up(i + 1)  # keep the window full while we import
                self._process(batch)
                self._export_batch_states(batches)
        return self.chain.head_state.state.slot

    def _download(self, batch: SyncBatch) -> None:
        while batch.failed_attempts <= MAX_BATCH_RETRIES:
            peer = self._pick_peer(batch)
            batch.status = BatchStatus.DOWNLOADING
            try:
                # concurrent window batches may land on the same peer;
                # IPeer implementations serialize requests internally
                batch.blocks = peer.beacon_blocks_by_range(
                    batch.start_slot, batch.count
                )
                batch.status = BatchStatus.AWAITING_PROCESSING
                return
            except PeerError:
                batch.failed_attempts += 1
                batch.failed_peers.add(peer.peer_id)
                batch.status = BatchStatus.AWAITING_DOWNLOAD
        batch.status = BatchStatus.FAILED
        raise RangeSyncError(
            f"batch at slot {batch.start_slot} failed after retries"
        )

    def _process(self, batch: SyncBatch) -> None:
        import time as _time

        batch.status = BatchStatus.PROCESSING
        t0 = _time.monotonic()
        try:
            # segment import: the WHOLE batch's signature sets verify as
            # one batched dispatch (reference verifyBlocksSignatures —
            # ~8k sigs per mainnet segment in one worker batch)
            self.chain.process_block_segment(
                batch.blocks, verify_signatures=self.verify_signatures
            )
            batch.status = BatchStatus.PROCESSED
            if self.metrics is not None:
                self.metrics.sync_range_batches_total.inc(outcome="processed")
                self.metrics.sync_blocks_imported_total.inc(len(batch.blocks))
                self.metrics.sync_segment_seconds.observe(_time.monotonic() - t0)
        except Exception as e:
            # a bad segment sends the batch back for re-download from a
            # different peer (reference: batch retry on processing failure)
            batch.failed_attempts += 1
            batch.status = BatchStatus.FAILED
            if self.metrics is not None:
                self.metrics.sync_range_batches_total.inc(outcome="failed")
            raise RangeSyncError(f"processing failed: {e}") from e
