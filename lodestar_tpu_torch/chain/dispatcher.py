"""Continuous-batching BLS dispatcher with priority lanes (the JAX
package's `chain/dispatcher.py`).

- **Coalescing.** Requests arriving while the device is busy merge into
  the next batch, up to `max_coalesce` sets.
- **Double-buffering.** `workers` threads (default 2) call the wrapped
  verifier at once, so the host marshal of batch N+1 overlaps the device
  work of batch N.
- **Priority lanes.** block > sync_committee > aggregate > attestation;
  a batch is drained in strict lane order, so a block's sets ride the
  first batch out.
- **Admission control.** Per-lane caps (the block lane is never capped
  or shed) and a global pending cap; under flood, queued attestations are
  evicted first, then aggregates, then sync-committee messages. A shed
  waiter gets a prompt typed `BlsShedError`. While the supervisor's
  breaker is open (the host tier serving), the lane caps halve.

- **Waits.** Each call's seconds in its lane go to the pipeline's stage
  `lane_wait` as its batch leaves. A caller inside a lifecycle trace gets
  one `bls/lane_batch` event on its span after the batch: its lane wait,
  the batch's sets and id (shared by the batch's calls), the batch's
  dispatch-queue wait and, when one ran, its audit seconds (the
  supervisor's `take_call_timings`).

The JAX module reads its defaults from LODESTAR_TPU_* variables; here
they are constructor arguments with the same values (`LANE_WORKERS`,
`LANE_MAX_COALESCE`, `LANE_PENDING_CAP`, `LANE_CAPS`, h2c dedup on).
All `# guarded-by: _lock` state is mutated only inside `*_locked`
helpers; the Condition wraps the same `self._lock`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import logging

from .bls_verifier import (
    MAX_BUFFER_WAIT_MS,
    MAX_BUFFERED_SIGS,
    WAITER_TIMEOUT_S,
    BlsShedError,
    ThreadBufferedVerifier,
    _verify_merged,
)
from ..observability import device_ledger, spans

__all__ = ["BlsLaneDispatcher", "BlsShedError", "LANES", "DEFAULT_LANE"]

_log = logging.getLogger("bls-verifier")

# Strict priority order, highest first (reference gossip queue shapes).
LANES = ("block", "sync_committee", "aggregate", "attestation")
LANE_PRIORITY = {lane: i for i, lane in enumerate(LANES)}
DEFAULT_LANE = "aggregate"


# the JAX package's LODESTAR_TPU_LANE_* defaults; block is deliberately
# absent from the caps: the block lane is never capped
LANE_WORKERS = 2
LANE_MAX_COALESCE = 512
LANE_PENDING_CAP = 4096
LANE_CAPS = {"sync_committee": 512, "aggregate": 1024, "attestation": 2048}


class BlsLaneDispatcher(ThreadBufferedVerifier):
    """Drop-in `ThreadBufferedVerifier` replacement with continuous
    batching, four priority lanes, and flood load-shedding.

    `verify_signature_sets(sets, batchable=True, lane="aggregate")`
    blocks the calling (gossip-executor) thread until its verdict is
    ready, exactly like the base facade — but raises `BlsShedError`
    promptly when admission control sheds the request. Unknown lanes
    route to the default lane, so existing callers keep working
    unchanged."""

    def __init__(self, verifier, max_sigs: int = MAX_BUFFERED_SIGS,
                 max_wait_ms: float = MAX_BUFFER_WAIT_MS, prom=None, pipeline=None,
                 waiter_timeout_s: float = WAITER_TIMEOUT_S,
                 workers: int = LANE_WORKERS, max_coalesce: int = LANE_MAX_COALESCE,
                 pending_cap: int = LANE_PENDING_CAP,
                 lane_caps: dict[str, int] | None = None, h2c_dedup: bool = True):
        super().__init__(verifier, max_sigs=max_sigs, max_wait_ms=max_wait_ms, prom=prom,
                         pipeline=pipeline, waiter_timeout_s=waiter_timeout_s)
        self.workers = workers
        self.max_coalesce = max_coalesce
        self.pending_cap = pending_cap
        self.lane_caps = dict(LANE_CAPS if lane_caps is None else lane_caps)
        # H(msg) dedup at the coalescing point: a flood of aggregates for
        # one attestation pays one hash_to_g2
        self._h2c_dedup = bool(h2c_dedup)
        # the Condition shares self._lock (created by the base __init__),
        # so waiters/notifies and the guarded-by annotations agree
        self._cv = threading.Condition(self._lock)
        # entry: (sets, event, holder, lane, t_enqueued, the caller's
        # lifecycle span or None)
        self._lane_q: dict[str, deque] = {lane: deque() for lane in LANES}  # guarded-by: _lock
        self._lane_sets: dict[str, int] = {lane: 0 for lane in LANES}  # guarded-by: _lock
        self._pending_sets = 0  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._batch_ids = itertools.count(1)
        self.pipeline.bind_lane_depths(self._lanes_state)
        self._threads = [
            threading.Thread(
                target=self._worker_loop, name=f"bls-lane-worker-{i}", daemon=True
            )
            for i in range(max(1, self.workers))
        ]
        for t in self._threads:
            t.start()

    # -- observability ------------------------------------------------------

    def _buffered_sigs(self) -> int:
        with self._lock:
            return self._pending_sets

    def _lanes_state(self) -> dict:
        """Live state for `/debug/lanes` and `pipeline.lanes_snapshot()`."""
        with self._lock:
            return {
                "lanes": {
                    lane: {
                        "queued_sets": self._lane_sets[lane],
                        "queued_requests": len(self._lane_q[lane]),
                        "cap": self.lane_caps.get(lane, 0),
                    }
                    for lane in LANES
                },
                "pending_sets": self._pending_sets,
                "pending_cap": self.pending_cap,
                "inflight_batches": self._inflight,
                "workers": len(self._threads),
                "max_coalesce": self.max_coalesce,
                "closed": self._closed,
            }

    # -- admission ----------------------------------------------------------

    def _breaker_open(self) -> bool:
        """True when the wrapped (supervised) verifier's breaker is open —
        device evicted, CPU tier serving — so effective lane caps halve:
        a ~300x slower tier needs a shorter queue, not a longer one."""
        try:
            return getattr(self.verifier, "breaker_state", None) == "open"
        except Exception:
            return False  # unsupervised verifier: no breaker, no halving

    def verify_signature_sets(self, sets, batchable: bool = True,
                              lane: str = DEFAULT_LANE) -> bool:
        sets = list(sets)
        if not sets:
            return False
        if lane not in LANE_PRIORITY:
            lane = DEFAULT_LANE
        # latency-critical callers and calls already at batch size skip
        # the queue entirely (base-facade contract, batchable=False)
        if not batchable or len(sets) >= self.max_sigs:
            if self.prom is not None:
                self.prom.bls_main_thread_sets_total.inc(len(sets))
            return self.verifier.verify_signature_sets(sets)
        ev = threading.Event()
        holder: list = [None]
        span = spans.tracer.context()
        with self._cv:
            if self._closed:
                shed, direct = None, True
            else:
                shed = self._admit_locked(sets, ev, holder, lane, span)
                direct = False
        if direct:
            return self.verifier.verify_signature_sets(sets)
        if shed is not None:
            raise shed
        return self._await(ev, holder, len(sets), lane)

    def _admit_locked(self, sets, ev, holder, lane, span=None):
        """Admission control under the lock. Returns a `BlsShedError` to
        raise (request NOT queued) or None (queued, worker notified)."""
        n = len(sets)
        cap = self.lane_caps.get(lane, 0)
        if cap and self._breaker_open():
            cap = max(1, cap // 2)
        if cap and lane != "block" and self._lane_sets[lane] + n > cap:
            self.pipeline.lane_shed(lane, n)
            return BlsShedError(lane, n, "lane cap")
        if self.pending_cap and self._pending_sets + n > self.pending_cap:
            # flood: evict strictly-lower-priority queued work first …
            self._evict_locked(
                self._pending_sets + n - self.pending_cap, LANE_PRIORITY[lane]
            )
            # … and if that freed nothing (we ARE the lowest priority
            # with work), shed the incoming request — unless it's a block
            if self._pending_sets + n > self.pending_cap and lane != "block":
                self.pipeline.lane_shed(lane, n)
                return BlsShedError(lane, n, "pending cap")
        self._lane_q[lane].append((sets, ev, holder, lane, time.monotonic(), span))
        self._lane_sets[lane] += n
        self._pending_sets += n
        if self.prom is not None:
            self.prom.bls_buffer_depth.set(self._pending_sets)
        self.pipeline.lane_depth_set(lane, self._lane_sets[lane])
        self._cv.notify()
        return None

    def _evict_locked(self, need: int, incoming_priority: int) -> int:
        """Shed queued entries from the lowest-priority non-empty lane
        upward until `need` sets are freed, never touching the block lane
        or any lane at/above the incoming request's priority. Evicted
        waiters resolve IMMEDIATELY with the typed rejection."""
        freed = 0
        for lane in reversed(LANES):  # attestation first, block last
            if LANE_PRIORITY[lane] <= incoming_priority or lane == "block":
                break
            q = self._lane_q[lane]
            evicted = 0
            while q and freed < need:
                e_sets, e_ev, e_holder, e_lane, *_ = q.popleft()
                k = len(e_sets)
                self._lane_sets[lane] -= k
                self._pending_sets -= k
                freed += k
                evicted += k
                e_holder[0] = BlsShedError(
                    e_lane, k, "evicted by higher-priority traffic"
                )
                e_ev.set()
            if evicted:
                self.pipeline.lane_shed(lane, evicted)
                self.pipeline.lane_depth_set(lane, self._lane_sets[lane])
            if freed >= need:
                break
        return freed

    # -- worker loop (continuous batching) ----------------------------------

    def _ready_reason_locked(self):
        """Why the head-of-queue work should dispatch NOW, or None."""
        if self._pending_sets == 0:
            return None
        if self._lane_q["block"]:
            return "priority"  # a block never waits out the timer window
        if self._pending_sets >= self.max_sigs:
            return "size"
        if self._inflight and self._pending_sets >= max(1, self.max_sigs // 2):
            # device busy and a half-batch is waiting: prep it now so the
            # host marshal overlaps the in-flight device step
            return "overlap"
        oldest = self._oldest_enqueue_locked()
        if oldest is not None and time.monotonic() - oldest >= self.max_wait:
            return "timer"
        return None

    def _oldest_enqueue_locked(self):
        oldest = None
        for q in self._lane_q.values():
            if q and (oldest is None or q[0][4] < oldest):
                oldest = q[0][4]
        return oldest

    def _wait_timeout_locked(self) -> float | None:
        oldest = self._oldest_enqueue_locked()
        if oldest is None:
            return None  # nothing queued: sleep until notified
        return max(0.001, self.max_wait - (time.monotonic() - oldest))

    def _pop_locked(self):
        """Drain queued entries in strict lane-priority order, coalescing
        up to `max_coalesce` sets into one device batch (always at least
        one entry, however large)."""
        entries: list = []
        n_sets = 0
        for lane in LANES:
            q = self._lane_q[lane]
            while q and (not entries or n_sets + len(q[0][0]) <= self.max_coalesce):
                e = q.popleft()
                k = len(e[0])
                self._lane_sets[lane] -= k
                self._pending_sets -= k
                n_sets += k
                entries.append(e)
            self.pipeline.lane_depth_set(lane, self._lane_sets[lane])
            if entries and n_sets >= self.max_coalesce:
                break
        if self.prom is not None:
            self.prom.bls_buffer_depth.set(self._pending_sets)
        return entries, n_sets

    def _begin_batch_locked(self) -> bool:
        overlapped = self._inflight > 0
        self._inflight += 1
        return overlapped

    def _end_batch_locked(self) -> None:
        self._inflight -= 1
        self._cv.notify_all()

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed:
                        return  # close() already shed every queued entry
                    reason = self._ready_reason_locked()
                    if reason is not None:
                        break
                    self._cv.wait(self._wait_timeout_locked())
                entries, n_sets = self._pop_locked()
                overlapped = self._begin_batch_locked()
            try:
                if entries:
                    self._dispatch_batch(entries, n_sets, reason, overlapped)
            finally:
                with self._cv:
                    self._end_batch_locked()

    def _dispatch_batch(self, entries, n_sets, reason, overlapped) -> None:
        now = time.monotonic()
        waits = [now - enq for _, _, _, _, enq, _ in entries]
        for wait in waits:
            self.pipeline.observe_stage("lane_wait", wait)
            if self.prom is not None:
                self.prom.bls_buffer_wait_seconds.observe(wait)
        self.pipeline.lane_coalesce(n_sets)
        self.pipeline.lane_overlap(overlapped)
        self._dedup_h2c(entries)
        t0 = time.monotonic()
        try:
            # device-time attribution: entries drain in strict priority
            # order, so the batch is charged to its highest-priority lane
            with device_ledger.ledger().lane_flush(
                entries[0][3], overlapped=overlapped
            ):
                per_request = _verify_merged(
                    self.verifier, [e[0] for e in entries], self.metrics,
                    self.prom,
                )
        except Exception:
            per_request = [False] * len(entries)
            _log.exception("lane batch verification failed; resolving %d requests as "
                           "invalid", len(entries))
        self.pipeline.flush(reason, latency_s=time.monotonic() - t0)
        # the supervisor's dispatch-queue wait and audit seconds of this
        # batch's calls, taken on every batch so none carries over
        take = getattr(self.verifier, "take_call_timings", None)
        timings = take() if take is not None else {}
        if any(span is not None for *_, span in entries):
            self._trace_batch(entries, waits, n_sets, timings)
        for (_, ev, holder, *_), verdict in zip(entries, per_request):
            holder[0] = verdict
            ev.set()

    def _trace_batch(self, entries, waits, n_sets: int, timings: dict) -> None:
        """One `bls/lane_batch` event on each traced caller's span (the
        caller still waits on its event, so its span is open)."""
        batch = next(self._batch_ids)
        for (*_, span), wait in zip(entries, waits):
            if span is not None:
                span.event("bls/lane_batch", lane_wait_s=round(wait, 6), sets=n_sets,
                           batch=batch, **timings)

    def _dedup_h2c(self, entries) -> None:
        """H(msg) dedup across the coalesced batch: committee
        traffic repeats attestation data across aggregates, so hash each
        UNIQUE 32-byte root once through the verifier's h2c cache before
        the marshal path walks the sets. Purely a pre-warm — the marshal
        path then hits `_h2c_cache` for every duplicate, so verdicts are
        bit-identical with dedup on or off. Verifiers without `warm_h2c`
        (mock/CPU tiers) skip silently."""
        if not self._h2c_dedup:
            return
        warm = getattr(self.verifier, "warm_h2c", None)
        if warm is None:
            return
        seen: set = set()
        dupes = 0
        for sets, *_ in entries:
            for s in sets:
                try:
                    m = bytes(s.message)
                except (AttributeError, TypeError, ValueError):
                    continue  # mock/opaque sets have no message shape
                if len(m) != 32:
                    continue
                if m in seen:
                    dupes += 1
                else:
                    seen.add(m)
        if not seen:
            return
        try:
            warm(seen)
        except Exception:
            _log.exception("h2c dedup pre-warm failed")
            return
        self.pipeline.h2c_dedup(dupes)

    # -- lifecycle ----------------------------------------------------------

    def _close_locked(self) -> None:
        self._closed = True
        for lane in LANES:
            q = self._lane_q[lane]
            shed = 0
            while q:
                e_sets, e_ev, e_holder, e_lane, *_ = q.popleft()
                k = len(e_sets)
                self._lane_sets[lane] -= k
                self._pending_sets -= k
                shed += k
                e_holder[0] = BlsShedError(e_lane, k, "dispatcher closed")
                e_ev.set()
            if shed:
                self.pipeline.lane_shed(lane, shed)
            self.pipeline.lane_depth_set(lane, 0)
        self._cv.notify_all()

    def close(self) -> None:
        """Stop the workers; queued waiters get the prompt typed shed
        rejection (the node is shutting down, not wedged). Idempotent;
        post-close verify calls go straight to the wrapped verifier."""
        with self._cv:
            if self._closed:
                return
            self._close_locked()
        for t in self._threads:
            t.join(timeout=10.0)
