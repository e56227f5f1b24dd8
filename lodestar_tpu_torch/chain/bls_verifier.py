"""The verifier boundary of the serving stack (the JAX package's
`chain/bls_verifier.py`), over the port's own verdicts:

- `IBlsVerifier`, the protocol every tier and facade implements, and
  `BlsShedError`, the typed rejection of a request the lane dispatcher
  sheds (callers map it to the gossip IGNORE action);
- `CpuBlsVerifier`, the host tier: the port's C library
  (`native.verify_sets`, two pairings per set, the GIL released), the
  supervisor's fallback and audit oracle;
- `DeviceBlsVerifier`, the device tier over `TorchBlsVerifier`;
- `BufferedVerifier` (asyncio) and `ThreadBufferedVerifier` (threads),
  which merge concurrent requests into one batch and fall back to
  per-set verdicts when it fails (`_verify_merged`, the one copy of that
  rule), and `MockBlsVerifier`, a constant verdict for tests.

`DeviceBlsVerifier`'s seams are the JAX facade's:

- `verify_signature_sets` and `verify_signature_sets_individual`, in jobs
  of at most `max_sets_per_job` sets (the JAX facade's `buckets[-1]`,
  128: the reference's chunkifyMaximizeChunkSize), each job inside a
  `trace.annotation` (`torch.profiler.record_function`) scope;
- `start_profiling(trace_dir)` / `stop_profiling()`, the process-wide
  `torch.profiler` switch of `observability.trace` (the JAX facade also
  starts a trace from LODESTAR_TPU_PROFILE; the port only when asked);
- `observer`, `h2c_cache_size`, `warm_h2c`, `epoch_table_populate` and
  `epoch_table_snapshot`, passed through to `TorchBlsVerifier`;
- the mesh and fleet seams (`mesh_evict`, `mesh_readmit`,
  `mesh_has_evicted`, `mesh_snapshot`, `mesh_evict_host`,
  `fleet_snapshot`, `fleet_attach_router`), passed through to
  `TorchBlsVerifier` and its `BlsMeshDispatcher`, if it has one; without
  one they answer as the JAX verifier does without a mesh (no eviction,
  nothing to readmit, no snapshot). Unlike the JAX facade, this one takes
  a `mesh` argument ("auto", a dispatcher or None) and a `fleet` argument
  (a `FleetTopology`, which the JAX facade reads from its environment)
  and passes them on; `close()` stops the mesh's worker processes.

Device decompression of the signatures is the default path; a batch
outside its 32 B root / 96 B signature shape is marshalled on the host,
and that downgrade is counted (`observer.decompress_fallback`) and
logged at most once a minute.

The port has no Python big-integer oracle: where the JAX host tier falls
back to one (a signature that is not 96 bytes, a pubkey that does not
encode), `CpuBlsVerifier` answers False for that set.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Protocol, Sequence

from ..bls.api import DST_G2
from ..observability import trace
from ..observability.stages import default_pipeline
from ..parallel.verifier import TorchBlsVerifier

MAX_SIGNATURE_SETS_PER_JOB = 128
MAX_BUFFERED_SIGS = 32
MAX_BUFFER_WAIT_MS = 100
WAITER_TIMEOUT_S = 300.0  # the JAX package's LODESTAR_TPU_WAITER_TIMEOUT default

_log = logging.getLogger("bls-verifier")


class BlsShedError(RuntimeError):
    """Typed rejection of a verify request shed by the lane dispatcher's
    admission control (lane caps, flood shedding, close).

    Waiters of a shed request get it promptly (the shed decision resolves
    their event at once), never after the waiter timeout, which is for a
    wedged flush thread. Callers map it to the gossip IGNORE action:
    shedding our own overload must not penalize peers."""

    def __init__(self, lane: str, n_sets: int, why: str = "shed"):
        super().__init__(f"bls verify request shed ({why}): lane={lane} sets={n_sets}")
        self.lane = lane
        self.n_sets = n_sets


class IBlsVerifier(Protocol):
    def verify_signature_sets(self, sets: Sequence) -> bool: ...

    def verify_signature_sets_individual(self, sets: Sequence) -> list[bool]: ...


class CpuBlsVerifier:
    """The host tier: the port's C library (`native.verify_sets`: G1 and
    G2 decompression with subgroup checks, hash-to-curve and two pairings
    per set, one thread, the GIL released), the JAX `CpuBlsVerifier`'s
    native route. A set whose signature is not 96 bytes or whose pubkey
    is not 48 bytes is refused by that route; with no Python oracle to
    fall back to, the port answers False for it."""

    @staticmethod
    def _eligible(s) -> bool:
        try:
            return len(s.signature) == 96 and len(s.pubkey.to_bytes()) == 48
        except (AttributeError, TypeError, ValueError):
            return False

    @staticmethod
    def _native_verify(sets) -> list[bool]:
        from .. import native

        return native.verify_sets(
            b"".join(s.pubkey.to_bytes() for s in sets), [bytes(s.message) for s in sets],
            b"".join(s.signature for s in sets), DST_G2,
        )

    def verify_signature_sets(self, sets) -> bool:
        sets = list(sets)
        if not sets or not all(self._eligible(s) for s in sets):
            return False
        return all(self._native_verify(sets))

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        sets = list(sets)
        ok = [self._eligible(s) for s in sets]
        idx = [i for i, e in enumerate(ok) if e]
        out = [False] * len(sets)
        if idx:
            for i, v in zip(idx, self._native_verify([sets[i] for i in idx])):
                out[i] = v
        return out


class DeviceBlsVerifier:
    """Device-tier verifier over the port's batch and per-set verdicts.

    `device` (default: the GPU; raises without one), `grouped_configs`,
    `pk_grouped_configs`, `observer` (default: the port's
    `default_pipeline()`), `faults`, `rng`, `mesh` and `fleet` go to
    `TorchBlsVerifier`; `max_sets_per_job` is the most sets one call of
    it verifies."""

    _FALLBACK_LOG_INTERVAL_S = 60.0

    def __init__(
        self,
        device=None,
        grouped_configs: tuple[tuple[int, int], ...] = ((16, 8), (64, 64)),
        pk_grouped_configs: tuple[tuple[int, int], ...] = ((128, 32),),
        max_sets_per_job: int = MAX_SIGNATURE_SETS_PER_JOB,
        observer=None,
        faults=None,
        rng=None,
        mesh="auto",
        fleet=None,
    ):
        self._inner = TorchBlsVerifier(
            device=device, grouped_configs=grouped_configs, rng=rng,
            pk_grouped_configs=pk_grouped_configs, observer=observer, faults=faults, mesh=mesh,
            fleet=fleet,
        )
        self.observer = self._inner.observer
        self.device = self._inner.device  # the supervisor's dispatch thread selects it
        self.max_sets_per_job = int(max_sets_per_job)
        self._last_fallback_log = float("-inf")

    def _annotate(self, label: str):
        return trace.annotation(label)

    def start_profiling(self, trace_dir: str | None = None) -> str | None:
        """Start the process-wide trace; None if one is already running."""
        return trace.start_profiling(trace_dir)

    def stop_profiling(self) -> str | None:
        """Stop it and write its Chrome trace; returns the directory."""
        return trace.stop_profiling()

    def h2c_cache_size(self) -> int:
        return len(self._inner._h2c_cache)

    def close(self) -> None:
        """Stop the mesh's worker processes (none without a mesh)."""
        self._inner.close()

    # -- mesh and fleet seams (the supervisor's failure policy) ----------------

    def mesh_evict(self, chip: int | None = None, reason: str = "failure"):
        return self._inner.mesh_evict(chip=chip, reason=reason)

    def mesh_readmit(self) -> int:
        return self._inner.mesh_readmit()

    def mesh_has_evicted(self) -> bool:
        return self._inner.mesh_has_evicted()

    def mesh_snapshot(self):
        return self._inner.mesh_snapshot()

    def mesh_evict_host(self, host: int | None = None, reason: str = "failure"):
        return self._inner.mesh_evict_host(host=host, reason=reason)

    def fleet_snapshot(self):
        return self._inner.fleet_snapshot()

    def fleet_attach_router(self, router) -> None:
        self._inner.fleet_attach_router(router)

    # -- epoch-scoped precomputation -------------------------------------------

    def warm_h2c(self, messages) -> int:
        return self._inner.warm_h2c(messages)

    def epoch_table_populate(self, epoch: int, pubkeys) -> int:
        return self._inner.epoch_table_populate(epoch, pubkeys)

    def epoch_table_snapshot(self):
        return self._inner.epoch_table_snapshot()

    def _note_decompress_fallback(self, sets) -> None:
        """Count, and log at most once a minute, a batch that device
        decompression cannot take and the host marshals instead."""
        if not sets or not self._inner._device_decompress:
            return
        if self._inner._native_eligible(sets):
            return
        self.observer.decompress_fallback()
        now = time.monotonic()
        if now - self._last_fallback_log >= self._FALLBACK_LOG_INTERVAL_S:
            self._last_fallback_log = now
            _log.warning(
                "device-decompress batch (%d sets) fell back to host marshal: "
                "non-standard message/signature lengths; further downgrades counted "
                "by observer.decompress_fallback", len(sets),
            )

    # -- verdicts ----------------------------------------------------------------

    def verify_signature_sets(self, sets) -> bool:
        sets = list(sets)
        if not sets:
            return False
        self._note_decompress_fallback(sets)
        with self._annotate(f"bls_verify_batch/{len(sets)}"):
            for i in range(0, len(sets), self.max_sets_per_job):
                if not self._inner.verify_signature_sets(sets[i: i + self.max_sets_per_job]):
                    return False
            return True

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        sets = list(sets)
        self._note_decompress_fallback(sets)
        out: list[bool] = []
        with self._annotate(f"bls_verify_individual/{len(sets)}"):
            for i in range(0, len(sets), self.max_sets_per_job):
                out.extend(self._inner.verify_signature_sets_individual(
                    sets[i: i + self.max_sets_per_job]))
        return out


class BufferedVerifier:
    """Async batching front-end over any IBlsVerifier.

    verify(sets, batchable=True) awaits the batched verdict for its sets
    only: a failed merged batch falls back to per-set verification so one
    bad gossip object cannot poison its neighbours."""

    def __init__(self, verifier: IBlsVerifier, prom=None, pipeline=None):
        self.verifier = verifier
        self._buffer: list[tuple[list, asyncio.Future, float]] = []
        self._flush_task: asyncio.Task | None = None
        self.metrics = {"batches": 0, "sigs_verified": 0, "batch_fallbacks": 0}
        # `metrics/bls.py` families (queue depth, buffer wait, sets per
        # job, fallbacks), if given
        self.prom = prom
        self.pipeline = pipeline or getattr(prom, "pipeline", None) or default_pipeline()
        self.pipeline.bind_buffer_depth(lambda: sum(len(s) for s, _, _ in self._buffer))

    async def verify(self, sets: Sequence, batchable: bool = False) -> bool:
        sets = list(sets)
        if not sets:
            return False
        if not batchable:
            return self.verifier.verify_signature_sets(sets)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._buffer.append((sets, fut, time.monotonic()))
        buffered = sum(len(s) for s, _, _ in self._buffer)
        if self.prom is not None:
            self.prom.bls_buffer_depth.set(buffered)
        if buffered >= MAX_BUFFERED_SIGS:
            self._flush(reason="size")
        elif self._flush_task is None:
            self._flush_task = loop.create_task(self._delayed_flush())
        return await fut

    async def _delayed_flush(self) -> None:
        await asyncio.sleep(MAX_BUFFER_WAIT_MS / 1000)
        self._flush(reason="timer")

    def _flush(self, reason: str = "manual") -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        buffer, self._buffer = self._buffer, []
        if not buffer:
            return
        now = time.monotonic()
        if self.prom is not None:
            for _, _, enq in buffer:
                self.prom.bls_buffer_wait_seconds.observe(now - enq)
        t0 = time.monotonic()
        try:
            per_request = _verify_merged(self.verifier, [b[0] for b in buffer], self.metrics,
                                         self.prom)
        except Exception as e:  # resolve waiters rather than hang them
            per_request = [False] * len(buffer)
            _log.error("buffered batch verification failed (%s); resolving %d requests as "
                       "invalid", e, len(buffer))
        self.pipeline.flush(reason, latency_s=time.monotonic() - t0)
        for (_, fut, _), verdict in zip(buffer, per_request):
            if not fut.done():
                fut.set_result(verdict)


def _verify_merged(verifier, set_groups, metrics, prom) -> list[bool]:
    """Merge request groups into one batch verification with the per-set
    fallback, updating the shared metric families; returns one verdict
    per group. The one copy of the batching rule behind both facades and
    the lane dispatcher."""
    merged: list = []
    for sets in set_groups:
        merged.extend(sets)
    metrics["batches"] += 1
    metrics["sigs_verified"] += len(merged)
    if prom is not None:
        prom.bls_buffer_depth.set(0)
        prom.bls_job_sets.observe(len(merged))
        prom.bls_batches_total.inc()
        prom.bls_sets_total.inc(len(merged))
    if verifier.verify_signature_sets(merged):
        return [True] * len(set_groups)
    metrics["batch_fallbacks"] += 1
    if prom is not None:
        prom.bls_batch_fallbacks_total.inc()
    verdicts = verifier.verify_signature_sets_individual(merged)
    out = []
    pos = 0
    for sets in set_groups:
        share = verdicts[pos: pos + len(sets)]
        pos += len(sets)
        out.append(all(share))
    return out


class ThreadBufferedVerifier:
    """Sync IBlsVerifier facade merging concurrent verify calls into one
    batch: calls from several threads are buffered up to `max_sigs` sets
    or `max_wait_ms` and verified as one, with the per-set fallback when
    the batch fails. A lone caller is flushed by the wait-window timer.
    Every other attribute delegates to the wrapped verifier."""

    def __init__(self, verifier: IBlsVerifier, max_sigs: int = MAX_BUFFERED_SIGS,
                 max_wait_ms: float = MAX_BUFFER_WAIT_MS, prom=None, pipeline=None,
                 waiter_timeout_s: float = WAITER_TIMEOUT_S):
        self.verifier = verifier
        self.max_sigs = max_sigs
        self.max_wait = max_wait_ms / 1000.0
        # the last-resort escape of a waiter whose flush thread is wedged
        # past every deadline the supervisor enforces
        self.waiter_timeout = waiter_timeout_s
        self.prom = prom
        self._lock = threading.Lock()
        self._entries: list[tuple[list, object, list]] = []  # guarded-by: _lock
        self._timer: object | None = None  # guarded-by: _lock
        self.metrics = {"batches": 0, "sigs_verified": 0, "batch_fallbacks": 0}
        self.pipeline = (
            pipeline
            or getattr(prom, "pipeline", None)
            or getattr(verifier, "observer", None)
            or default_pipeline()
        )
        self.pipeline.bind_buffer_depth(self._buffered_sigs)

    def _buffered_sigs(self) -> int:
        with self._lock:
            return sum(len(e[0]) for e in self._entries)

    def __getattr__(self, name):
        if name == "verifier":  # not yet set (unpickling, copy): no recursion
            raise AttributeError(name)
        return getattr(self.verifier, name)

    def verify_signature_sets_individual(self, sets):
        return self.verifier.verify_signature_sets_individual(sets)

    def verify_signature_sets(self, sets, batchable: bool = True) -> bool:
        sets = list(sets)
        if not sets:
            return False
        # latency-critical callers and calls already at batch size skip
        # the wait window
        if not batchable or len(sets) >= self.max_sigs:
            if self.prom is not None:
                self.prom.bls_main_thread_sets_total.inc(len(sets))
            return self.verifier.verify_signature_sets(sets)
        ev = threading.Event()
        holder: list = [None]
        flush_now = None
        with self._lock:
            self._entries.append((sets, ev, holder))
            buffered = sum(len(e[0]) for e in self._entries)
            if self.prom is not None:
                self.prom.bls_buffer_depth.set(buffered)
            if buffered >= self.max_sigs:
                flush_now = self._take_locked()
            elif self._timer is None:
                self._timer = threading.Timer(self.max_wait, self._flush_timed)
                self._timer.daemon = True
                self._timer.start()
        if flush_now is not None:
            self._run_batch(flush_now, reason="size")
        return self._await(ev, holder, len(sets))

    def _await(self, ev, holder, n_sets: int, lane: str | None = None):
        """Wait for the verdict; a shed entry re-raises its `BlsShedError`."""
        if not ev.wait(self.waiter_timeout):
            self.pipeline.waiter_timeout()
            _log.error("verify waiter gave up after %.1fs: flush thread wedged (%d sets%s); "
                       "counted in lodestar_bls_verifier_waiter_timeouts_total",
                       self.waiter_timeout, n_sets, f", lane={lane}" if lane else "")
            out = holder[0]
            if isinstance(out, BlsShedError):
                raise out
            return out if out is not None else False
        out = holder[0]
        if isinstance(out, BlsShedError):
            raise out
        return out

    def _take_locked(self):
        entries, self._entries = self._entries, []
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return entries

    def _flush_timed(self):
        with self._lock:
            self._timer = None
            entries = self._take_locked()
        if entries:
            self._run_batch(entries, reason="timer")

    def _run_batch(self, entries, reason: str = "manual") -> None:
        """Verify a merged batch and resolve every entry, always: an
        exception here resolves the waiters False rather than hang them.
        Under `SupervisedBlsVerifier` a device failure never reaches this
        path (the host tier serves); False is left for both tiers failed."""
        t0 = time.monotonic()
        try:
            per_request = _verify_merged(self.verifier, [e[0] for e in entries], self.metrics,
                                         self.prom)
        except Exception:
            per_request = [False] * len(entries)
            _log.exception("buffered batch verification failed; resolving %d requests as "
                           "invalid", len(entries))
        self.pipeline.flush(reason, latency_s=time.monotonic() - t0)
        for (_, ev, holder), verdict in zip(entries, per_request):
            holder[0] = verdict
            ev.set()


class MockBlsVerifier:
    """Constant-result verifier for tests: every path around signature
    verification without paying for pairings."""

    def __init__(self, result: bool = True):
        self.result = result
        self.sets_seen = 0

    def verify_signature_sets(self, sets) -> bool:
        self.sets_seen += len(sets)
        return self.result

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        self.sets_seen += len(sets)
        return [self.result] * len(sets)
