"""Per-slot status logging (reference: `node/notifier.ts` runNodeNotifier —
the one-line "Synced - slot: X - head: Y - finalized: Z - peers: N" heartbeat).

The port's copy of the JAX package's `node/notifier.py`.
"""

from __future__ import annotations

import logging
import time


class NodeNotifier:
    def __init__(self, node, interval_slots: int = 1):
        self.node = node
        self.interval_slots = interval_slots
        self.log = logging.getLogger("notifier")
        self._last_head = b""
        self._last_t = time.monotonic()

    def on_slot(self, clock_slot: int) -> None:
        if clock_slot % self.interval_slots:
            return
        chain = self.node.chain
        head = chain.head_state
        now = time.monotonic()
        dt = now - self._last_t
        self._last_t = now
        head_moved = chain.head_root != self._last_head
        self._last_head = chain.head_root
        n_peers = len(getattr(self.node, "peers", ()) or ())
        self.log.info(
            "%s - slot: %d - head: %d %s - exec: %s - finalized: %d - peers: %d (%.1fs)",
            "Synced" if head_moved else "Searching head",
            clock_slot,
            head.state.slot,
            chain.head_root.hex()[:8],
            (
                bytes(head.state.latest_execution_payload_header.block_hash).hex()[:8]
                if head.is_execution
                else "-"
            ),
            chain.finalized_checkpoint[0],
            n_peers,
            dt,
        )
