"""Black-box flight recorder: a bounded ring of recent pipeline events
(the port's copy of the JAX package's module).

A run that is killed at its time limit should still say what it was
doing. Every interesting transition (kernel dispatch, library build or
first launch, breaker flip, lane shed, startup mark) drops a small dict
into a process-wide `collections.deque(maxlen=N)`, which a report can
read at any time, a watchdog's or a signal handler's included.

Stdlib only, import-light, never raises into the hot path. A `record()`
is one lock and one deque append, cheap enough for per-batch dispatch
events. The ring holds 256 events (the JAX package reads
LODESTAR_TPU_FLIGHT_RECORDER_SIZE, default 256; the port hard-codes the
default); `dump()` reports how many older events were dropped, so a
truncated history is visible, never silent.

Event shape: {"seq", "t_s", "kind", ...kind-specific fields}. `t_s` is
seconds since the recorder singleton was created.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "recorder", "record"]

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Bounded ring of recent events; thread-safe; drop-oldest."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = DEFAULT_CAPACITY
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._t0 = time.monotonic()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(self, kind: str, **fields) -> dict:
        """Append one event; returns it (tests assert on the shape)."""
        t_s = round(time.monotonic() - self._t0, 3)
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "t_s": t_s, "kind": kind, **fields}
            self._ring.append(event)
        return event

    def dump(self, limit: int | None = None) -> dict:
        """Snapshot for the bench doc / `/debug/compiles`: newest-last
        events plus enough bookkeeping to see what the ring dropped."""
        with self._lock:
            events = list(self._ring)
            total = self._seq
        if limit is not None and limit >= 0:
            events = events[-limit:]
        return {
            "capacity": self._ring.maxlen,
            "recorded_total": total,
            "dropped": total - len(events),
            "events": events,
        }


_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide ring every subsystem records into."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def record(kind: str, **fields) -> dict:
    """Module-level convenience: `flight_recorder.record("breaker", ...)`."""
    return recorder().record(kind, **fields)

