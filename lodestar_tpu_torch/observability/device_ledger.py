"""Device-time attribution + memory ledger: where device-seconds go (the
JAX package's `observability/device_ledger.py`).

- **Time attribution.** Two nesting context managers feed one busy
  account keyed by (lane, kernel, chip):

      `lane_flush(lane, overlapped)`  the lane dispatcher's double-buffer
          worker wraps each merged verify; sets the thread's lane so
          inner dispatches inherit it. When NO inner dispatch runs, the
          flush itself is attributed under kernel `lane_flush`, so a
          stack without a mesh still accounts its device wall time.
      `dispatch(kernel, chips)`  a mesh dispatcher wraps every sharded
          submit; each participating chip accrues the full dispatch
          seconds (all chips are busy simultaneously).

  A global in-flight counter turns the same intervals into busy-wall /
  idle-wall seconds (union of dispatch intervals vs ledger uptime), and
  a dispatch that begins while unrelated work is in flight (or whose
  lane_flush carried the dispatcher's overlap hint) also accrues
  `overlap` seconds: the double-buffering win.

- **Memory sampling.** A low-rate sampler (at most one sample per 10 s,
  piggybacked on snapshot calls, no polling thread) reads, per CUDA
  device, the caching allocator's counters from the host without a
  synchronisation: `torch.cuda.memory_stats(d)`'s
  `allocated_bytes.all.current` (in_use) and `allocated_bytes.all.peak`
  (peak), the card's memory (limit: `get_device_properties(d)`'s
  `total_memory`, the total of `mem_get_info`, read without a context) and
  `reserved_bytes.all.current` (live_buffers, what the allocator holds).
  It reads nothing before the process has initialised CUDA, and reports
  `{}` without a CUDA device, as the JAX reader does without a backend.
  It tracks a monotonic per-chip high watermark and drops a
  flight-recorder event on every rise. The JAX package reads the
  interval from LODESTAR_TPU_DEVICE_LEDGER_MEM_SAMPLE_S (default 10 s);
  the port hard-codes the default.

Everything exports as `lodestar_tpu_device_*` families on every attached
PipelineMetrics (same weakref fan-out as the compile ledger). Stdlib-only
on the hot path.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref

from . import flight_recorder

__all__ = ["DeviceLedger", "ledger"]

# snapshot keeps the top-N busiest (lane, kernel, chip) rows; the full
# account stays in the counters on /metrics
SNAPSHOT_TOP_N = 24

DEFAULT_MEM_SAMPLE_S = 10.0

# torch.cuda.memory_stats() keys -> exported `kind` label values
_MEM_STAT_KEYS = (
    ("allocated_bytes.all.current", "in_use"),
    ("allocated_bytes.all.peak", "peak"),
    ("reserved_bytes.all.current", "live_buffers"),
)


def _default_memory_stats() -> dict:
    """{chip: {kind: bytes}} from the CUDA caching allocator; empty
    without a CUDA device or before the process has initialised CUDA."""
    import torch

    out: dict = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        entry = {kind: int(stats[src]) for src, kind in _MEM_STAT_KEYS if src in stats}
        # the card's memory, as `mem_get_info(d)[1]` reads it, without
        # creating a context on a device this process does not use
        entry["limit"] = int(torch.cuda.get_device_properties(d).total_memory)
        out[str(d)] = entry
    return out


class DeviceLedger:
    """Busy/idle/overlap device-seconds by lane x kernel x chip + the
    memory watermark sampler."""

    def __init__(self, clock=time.monotonic, memory_stats_fn=None):
        self._clock = clock
        self._memory_stats_fn = memory_stats_fn
        self._lock = threading.Lock()
        self._t0 = clock()
        self._busy: dict[tuple, float] = {}  # guarded-by: _lock
        self._overlap: dict[tuple, float] = {}  # guarded-by: _lock
        self._dispatches = 0  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock  (bumped per inner dispatch)
        self._busy_wall_accum = 0.0  # guarded-by: _lock
        self._busy_wall_t0: float | None = None  # guarded-by: _lock
        self._mem: dict[str, dict] = {}  # guarded-by: _lock
        self._watermark: dict[str, int] = {}  # guarded-by: _lock
        self._mem_last_t: float | None = None  # guarded-by: _lock
        self._mem_samples = 0  # guarded-by: _lock
        self._pipelines: list = []  # guarded-by: _lock
        self._tls = threading.local()

    # -- pipeline fan-out ---------------------------------------------------

    def attach(self, pipeline) -> None:
        """Weakref-register a PipelineMetrics (PipelineMetrics.__init__
        calls this; dead refs are compacted on every attach)."""
        with self._lock:
            self._pipelines = [r for r in self._pipelines if r() is not None]
            self._pipelines.append(weakref.ref(pipeline))

    def pipelines(self) -> list:
        with self._lock:
            refs = list(self._pipelines)
        return [p for p in (r() for r in refs) if p is not None]

    # -- interval bookkeeping -----------------------------------------------

    def _begin_locked(self) -> tuple[float, int, int]:
        now = self._clock()
        foreign = self._inflight - getattr(self._tls, "depth", 0)
        if self._inflight == 0:
            self._busy_wall_t0 = now
        self._inflight += 1
        self._tls.depth = getattr(self._tls, "depth", 0) + 1
        return now, self._seq, foreign

    def _end_locked(self) -> float:
        now = self._clock()
        self._inflight -= 1
        self._tls.depth = getattr(self._tls, "depth", 1) - 1
        if self._inflight == 0 and self._busy_wall_t0 is not None:
            self._busy_wall_accum += now - self._busy_wall_t0
            self._busy_wall_t0 = None
        return now

    def _attribute(self, lane: str, kernel: str, chips, elapsed: float,
                   overlapped: bool) -> None:
        chips = tuple(str(c) for c in chips) or ("0",)
        with self._lock:
            self._dispatches += 1
            for chip in chips:
                key = (lane, kernel, chip)
                self._busy[key] = self._busy.get(key, 0.0) + elapsed
                if overlapped:
                    self._overlap[key] = self._overlap.get(key, 0.0) + elapsed
        for p in self.pipelines():
            for chip in chips:
                p.device_dispatch_time(
                    lane, kernel, chip, elapsed,
                    elapsed if overlapped else 0.0,
                )

    # -- the two instrumentation seams --------------------------------------

    @contextlib.contextmanager
    def lane_flush(self, lane: str, overlapped: bool = False):
        """Wrap one lane-dispatcher merged verify: sets the thread's lane
        so nested mesh dispatches attribute under it. Attributes the
        flush itself (kernel `lane_flush`, chip `0`) only when no inner
        dispatch ran, so nothing is counted twice."""
        tls = self._tls
        prev_lane = getattr(tls, "lane", None)
        prev_hint = getattr(tls, "overlap_hint", False)
        tls.lane = lane
        tls.overlap_hint = bool(overlapped)
        with self._lock:
            t0, seq0, foreign = self._begin_locked()
        try:
            yield
        finally:
            with self._lock:
                now = self._end_locked()
                inner = self._seq > seq0
            tls.lane = prev_lane
            tls.overlap_hint = prev_hint
            if not inner:
                self._attribute(
                    lane, "lane_flush", ("0",), now - t0,
                    bool(overlapped) or foreign > 0,
                )

    @contextlib.contextmanager
    def dispatch(self, kernel: str, chips):
        """Wrap one sharded device submit (a mesh dispatcher): each
        participating chip accrues the full elapsed seconds under the
        calling thread's lane (`unlabeled` outside a lane flush)."""
        tls = self._tls
        lane = getattr(tls, "lane", None) or "unlabeled"
        hint = getattr(tls, "overlap_hint", False)
        with self._lock:
            self._seq += 1
            t0, seq0, foreign = self._begin_locked()
        try:
            yield
        finally:
            with self._lock:
                now = self._end_locked()
                raced = self._seq > seq0
            self._attribute(
                lane, kernel, chips, now - t0,
                bool(hint) or foreign > 0 or raced,
            )

    # -- memory sampler -----------------------------------------------------

    def sample_memory(self, force: bool = False) -> None:
        """Low-rate memory sample (piggybacked on snapshot calls): at
        most one per DEFAULT_MEM_SAMPLE_S; `force` bypasses the limiter
        (tests, post-mortems)."""
        now = self._clock()
        with self._lock:
            if (not force and self._mem_last_t is not None
                    and now - self._mem_last_t < DEFAULT_MEM_SAMPLE_S):
                return
            self._mem_last_t = now
        fn = self._memory_stats_fn or _default_memory_stats
        try:
            stats = fn() or {}
        except Exception as e:
            flight_recorder.record("device_mem_sample_error", error=str(e))
            return
        rises: list[tuple[str, int]] = []
        with self._lock:
            self._mem_samples += 1
            self._mem = {chip: dict(entry) for chip, entry in stats.items()}
            for chip, entry in stats.items():
                in_use = int(entry.get("in_use", entry.get("live_buffers", 0)))
                prev = self._watermark.get(chip, 0)
                if in_use > prev:
                    self._watermark[chip] = in_use
                    rises.append((chip, in_use))
            watermarks = dict(self._watermark)
        for chip, value in rises:
            flight_recorder.record(
                "device_mem_watermark", chip=chip, bytes=value
            )
        for p in self.pipelines():
            for chip, entry in stats.items():
                for kind, value in entry.items():
                    p.device_memory_sample(chip, kind, value)
            for chip, value in watermarks.items():
                p.device_memory_watermark_set(chip, value)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The `/debug/device` document."""
        self.sample_memory()
        now = self._clock()
        with self._lock:
            busy_wall = self._busy_wall_accum
            if self._busy_wall_t0 is not None:
                busy_wall += now - self._busy_wall_t0
            uptime = max(0.0, now - self._t0)
            idle = max(0.0, uptime - busy_wall)
            rows = sorted(self._busy.items(), key=lambda kv: -kv[1])
            attributed = [
                {
                    "lane": key[0], "kernel": key[1], "chip": key[2],
                    "busy_s": round(busy, 6),
                    "overlap_s": round(self._overlap.get(key, 0.0), 6),
                }
                for key, busy in rows[:SNAPSHOT_TOP_N]
            ]
            snap = {
                "uptime_s": round(uptime, 3),
                "busy_wall_s": round(busy_wall, 6),
                "idle_wall_s": round(idle, 6),
                "utilization": round(busy_wall / uptime, 4) if uptime else 0.0,
                "dispatches": self._dispatches,
                "inflight": self._inflight,
                "attributed_busy_s": round(sum(self._busy.values()), 6),
                "attributed": attributed,
                "attributed_rows_dropped": max(0, len(rows) - SNAPSHOT_TOP_N),
                "memory": {
                    chip: {
                        **self._mem.get(chip, {}),
                        "watermark_bytes": self._watermark.get(chip, 0),
                    }
                    for chip in sorted(set(self._mem) | set(self._watermark))
                },
                "memory_samples": self._mem_samples,
            }
        for p in self.pipelines():
            p.device_idle(idle)
        return snap


# -- process-wide singleton ---------------------------------------------------

_ledger: DeviceLedger | None = None
_ledger_lock = threading.Lock()


def ledger() -> DeviceLedger:
    """The process-wide device ledger every dispatch seam records into."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = DeviceLedger()
        return _ledger

