"""Chain event bus.

Reference: `chain/emitter.ts` (`ChainEventEmitter`) — typed events fired
at block import/head update/finalization, consumed by the REST event
stream (`api/.../events.ts`), the notifier, and sim liveness trackers.

Thread-safe: emissions come from whichever thread imports blocks (event
loop, range-sync executor, REST), subscribers may be SSE streamer queues
on other threads.
"""

from __future__ import annotations

import logging
import threading
from enum import Enum

log = logging.getLogger("chain-emitter")


class ChainEvent(str, Enum):
    # reference eventstream topic names (routes/events.ts)
    head = "head"
    block = "block"
    attestation = "attestation"
    finalized_checkpoint = "finalized_checkpoint"
    chain_reorg = "chain_reorg"
    lightclient_optimistic_update = "light_client_optimistic_update"
    lightclient_finality_update = "light_client_finality_update"


class ChainEventEmitter:
    def __init__(self):
        self._subs: dict[ChainEvent, list] = {}
        self._lock = threading.Lock()

    def on(self, event: ChainEvent, callback) -> None:
        with self._lock:
            self._subs.setdefault(event, []).append(callback)

    def off(self, event: ChainEvent, callback) -> None:
        with self._lock:
            subs = self._subs.get(event, [])
            if callback in subs:
                subs.remove(callback)

    def emit(self, event: ChainEvent, payload: dict) -> None:
        with self._lock:
            subs = list(self._subs.get(event, ()))
        for cb in subs:
            try:
                cb(event, payload)
            except Exception:
                # a bad subscriber must not break block import
                log.warning("subscriber failed for %s", event, exc_info=True)
