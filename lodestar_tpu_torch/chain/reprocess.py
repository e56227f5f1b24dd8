"""Reprocess queue: hold attestations whose target block hasn't arrived.

Reference: `chain/reprocess.ts:51` (ReprocessController) — gossip
attestations referencing an unknown head block wait up to
WAIT_TIME_BEFORE_DROP for the block to be imported, then re-enter
validation; the block-import path notifies waiters by root.
"""

from __future__ import annotations

from dataclasses import dataclass, field

REPROCESS_MIN_WAIT_SEC = 2.0
MAX_QUEUED_TOTAL = 16_384  # global budget across all awaited roots


@dataclass
class _Waiting:
    items: list = field(default_factory=list)
    added_at: float = 0.0


class ReprocessController:
    def __init__(self, time_fn=None):
        import time as _time

        self._time = time_fn if time_fn is not None else _time.time
        self._by_root: dict[bytes, _Waiting] = {}
        self._total = 0  # running count — the budget check is on the hot path
        self.metrics = {"queued": 0, "resolved": 0, "dropped": 0}

    def wait_for_block(self, block_root: bytes, item) -> bool:
        """Queue `item` (an unvalidated attestation + its context) until
        `block_root` is imported. False when the global budget is spent —
        checked BEFORE creating any entry, so rejected floods of distinct
        unknown roots leave no residue."""
        if self._total >= MAX_QUEUED_TOTAL:
            self.metrics["dropped"] += 1
            return False
        waiting = self._by_root.setdefault(
            block_root, _Waiting(added_at=self._time())
        )
        waiting.items.append(item)
        self._total += 1
        self.metrics["queued"] += 1
        return True

    def on_block_imported(self, block_root: bytes) -> list:
        """Returns the queued items for this root — the caller re-runs
        gossip validation on each (reference: emits and re-validates)."""
        waiting = self._by_root.pop(block_root, None)
        if waiting is None:
            return []
        self._total -= len(waiting.items)
        self.metrics["resolved"] += len(waiting.items)
        return waiting.items

    def prune(self, max_age_sec: float = REPROCESS_MIN_WAIT_SEC) -> int:
        """Drop entries older than the wait budget; returns dropped count."""
        now = self._time()
        dropped = 0
        for root in [
            r for r, w in self._by_root.items() if now - w.added_at > max_age_sec
        ]:
            dropped += len(self._by_root.pop(root).items)
        self._total -= dropped
        self.metrics["dropped"] += dropped
        return dropped
