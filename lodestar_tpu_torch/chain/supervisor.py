"""Failure policy of the device tier (the JAX package's
`chain/supervisor.py`): `SupervisedBlsVerifier` sits between the
batching facades and `DeviceBlsVerifier`.

- **Per-dispatch deadline.** Every device call runs on a disposable
  daemon worker thread bounded by `deadline_s` (default 120 s, 0
  disables). A blown deadline abandons the worker and falls back; the
  next dispatch gets a fresh one. An abandoned thread cannot stop a
  kernel already on the card: a wedged kernel, or a sticky CUDA error
  such as an illegal address, poisons the process's CUDA context, the
  breaker then stays open and the host tier serves until a restart. Only
  a mesh worker process can be killed and replaced.
- **One jittered-backoff retry** for raised device errors (`retries`,
  default 1; `utils/retry.RetryPolicy`). Deadline blowouts are not
  retried.
- **Host-tier fallback.** When the device tier fails, callers get the
  `CpuBlsVerifier`'s verdicts instead of a blanket False; only when both
  tiers fail is the answer False, counted as `both_tiers_failed`.
- **Negative-verdict audit** (`audit_negative`, default on). A random
  hardware fault makes a pairing product that is not the identity (a
  spurious False) and cannot forge the identity (a spurious True), so a
  device False is re-checked on the host tier; an overturned verdict
  counts as a device failure and feeds the breaker.
- **Mesh chip and fleet host eviction.** With a `BlsMeshDispatcher`
  behind the facade, a failure the exception attributes (the port's
  `parallel/mesh_pool.MeshWorkerError`: `.chip`, `.host`) evicts that
  chip or host and the call is retried at once on the survivors: no
  retry budget spent, no breaker fed. The canary re-admits them.
- **Circuit breaker** (`failure_threshold`, default 3, consecutive
  failures). Open, traffic goes straight to the host tier. A canary
  thread probes a known-valid batch every `cooldown_s` (default 30 s):
  the probe moves the breaker half-open, a pass re-closes it, a failure
  re-opens it. Only the canary rides half-open.

The JAX module reads those defaults from LODESTAR_TPU_* variables; the
port takes them as arguments. Spans (`bls/supervised_batch`,
`bls/supervised_individual`, `bls/cpu_fallback`, `bls/canary_probe`) and
events (`bls/breaker_transition`, the evictions) go to the process-wide
`observability.spans.tracer`, as in the JAX package, or to an injected
`tracer` (duck-typed: `context()`, `span(name, **attrs)`,
`event(name, **attrs)`). A span opens only under a live trace of the
caller's thread. Counters go to the observer (`PipelineMetrics`: breaker state,
transitions, retries, fallbacks, deadlines, canary, mismatches) and
`breaker_snapshot()` serves `/debug/breaker`.

Two parts of a call's latency go to the observer's stage histogram: each
device call's wait for the one dispatch thread, from its hand-over to the
queue to the worker taking it (stage `dispatch_wait`; 0 on the inline
path; nothing for a call that blew its deadline), and the host tier's
seconds of a negative audit (stage `audit`, inside the profiler scope
`bls/audit`). `take_call_timings()` gives the calling thread's sums of
both since its last take: the lanes put them on their callers' traces.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import sys
import threading
import time

from ..observability import slo, spans
from ..observability.stages import default_pipeline
from ..utils.retry import RetryPolicy
from .bls_verifier import CpuBlsVerifier

BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
BREAKER_STATE_VALUES = {
    BREAKER_CLOSED: 0,
    BREAKER_HALF_OPEN: 1,
    BREAKER_OPEN: 2,
}

# the JAX package's LODESTAR_TPU_* defaults
DEVICE_DEADLINE_S = 120.0
DEVICE_RETRIES = 1
BREAKER_THRESHOLD = 3
BREAKER_COOLDOWN_S = 30.0
AUDIT_NEGATIVE = True


class DeviceDeadlineExceeded(RuntimeError):
    """A device dispatch outlived its watchdog deadline."""


class RateLimitedLogger:
    """At most one line per `interval_s` per key; suppressed lines are
    counted and the count is prepended to the next emitted one."""

    def __init__(self, logger: logging.Logger, interval_s: float = 30.0):
        self._logger = logger
        self._interval = interval_s
        self._last: dict[str, float] = {}
        self._suppressed: dict[str, int] = {}
        self._lock = threading.Lock()

    def log(self, level: int, key: str, msg: str, *args) -> bool:
        now = time.monotonic()
        with self._lock:
            if now - self._last.get(key, float("-inf")) < self._interval:
                self._suppressed[key] = self._suppressed.get(key, 0) + 1
                return False
            self._last[key] = now
            skipped, self._suppressed[key] = self._suppressed.get(key, 0), 0
        if skipped:
            msg = f"(+{skipped} suppressed) " + msg
        self._logger.log(level, msg, *args)
        return True

    def warning(self, key: str, msg: str, *args) -> bool:
        return self.log(logging.WARNING, key, msg, *args)

    def error(self, key: str, msg: str, *args) -> bool:
        return self.log(logging.ERROR, key, msg, *args)


class _DeadlineDispatcher:
    """Run callables on a disposable daemon worker, bounded by a deadline.

    One worker thread serves dispatches in order. When a call blows its
    deadline the worker is abandoned: it keeps running as a daemon until
    the call returns, notices its generation is stale and exits; the next
    dispatch starts a fresh worker. `cuda_index` (the verifier's card, or
    None) is made the worker's current device: PyTorch's current device
    is per thread. `concurrent.futures` is avoided: its workers are
    joined at interpreter exit, so a wedged thread would hang shutdown."""

    # past this many abandoned workers still running, dispatches fail at
    # once (the host tier serves) until one of them returns
    MAX_ABANDONED = 8

    def __init__(self, name: str = "bls-device-dispatch", cuda_index: int | None = None):
        self._name = name
        self._cuda_index = cuda_index
        self._lock = threading.Lock()
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._abandoned: list[threading.Thread] = []
        self._generation = 0

    def _ensure_worker(self) -> queue.Queue:
        with self._lock:
            if self._queue is not None and self._worker is not None \
                    and self._worker.is_alive():
                return self._queue
            self._generation += 1
            gen = self._generation
            q: queue.Queue = queue.Queue()

            def _loop():
                if self._cuda_index is not None:
                    import torch

                    torch.cuda.set_device(self._cuda_index)
                while True:
                    item = q.get()
                    if item is None:
                        return
                    fn, box, done = item
                    box["t_taken"] = time.monotonic()
                    try:
                        box["result"] = fn()
                    except BaseException as e:  # delivered to the waiter
                        box["error"] = e
                    finally:
                        done.set()
                    with self._lock:
                        if self._generation != gen:
                            return  # abandoned mid-call: don't linger

            worker = threading.Thread(target=_loop, name=self._name, daemon=True)
            worker.start()
            self._queue, self._worker = q, worker
            return q

    def run(self, fn, deadline_s: float | None, on_wait):
        """Execute `fn()`; raise DeviceDeadlineExceeded after
        `deadline_s` (None or ≤ 0: unbounded, executed inline). A call
        that ran (returned or raised) within its deadline passes
        `on_wait` the seconds it waited in the queue for the worker: 0
        inline."""
        if deadline_s is None or deadline_s <= 0:
            on_wait(0.0)
            return fn()
        with self._lock:
            self._abandoned = [t for t in self._abandoned if t.is_alive()]
            wedged = len(self._abandoned)
        if wedged >= self.MAX_ABANDONED:
            raise DeviceDeadlineExceeded(
                f"{wedged} wedged dispatch workers still draining; refusing to spawn more")
        q = self._ensure_worker()
        done = threading.Event()
        box: dict = {}
        t_put = time.monotonic()
        q.put((fn, box, done))
        if not done.wait(deadline_s):
            with self._lock:
                if self._queue is q:  # abandon the wedged worker
                    self._queue = None
                    if self._worker is not None:
                        self._abandoned.append(self._worker)
                    self._worker = None
                    self._generation += 1
            raise DeviceDeadlineExceeded(f"device dispatch exceeded {deadline_s:.3f}s deadline")
        on_wait(box["t_taken"] - t_put)
        if "error" in box:
            raise box["error"]
        return box["result"]

    def close(self) -> None:
        """Stop the worker and wait up to 5 s for it (an abandoned, wedged
        one is left to finish its call)."""
        with self._lock:
            q, worker = self._queue, self._worker
            self._queue = None
            self._worker = None
            self._generation += 1
        if q is not None:
            q.put(None)
        if worker is not None and worker is not threading.current_thread():
            worker.join(5.0)


def _cuda_index(device) -> int | None:
    """The CUDA card the device verifier runs on, or None (CPU, a fake)."""
    dev = getattr(device, "device", None)
    if getattr(dev, "type", None) != "cuda":
        return None
    if dev.index is not None:
        return dev.index
    import torch

    return torch.cuda.current_device()


class SupervisedBlsVerifier:
    """IBlsVerifier facade owning the device tier's failure policy.

    Every unknown attribute (h2c_cache_size, stop_profiling,
    max_sets_per_job, ...) delegates to the device tier: the facade adds
    policy, not surface."""

    def __init__(
        self,
        device,
        cpu=None,
        *,
        observer=None,
        deadline_s: float = DEVICE_DEADLINE_S,
        failure_threshold: int = BREAKER_THRESHOLD,
        cooldown_s: float = BREAKER_COOLDOWN_S,
        retries: int = DEVICE_RETRIES,
        retry_base_delay_s: float = 0.05,
        audit_negative: bool = AUDIT_NEGATIVE,
        canary_thread: bool = True,
        canary_sets=None,
        time_fn=time.monotonic,
        tracer=None,
    ):
        self.device = device
        self.cpu = cpu if cpu is not None else CpuBlsVerifier()
        self.observer = observer or getattr(device, "observer", None) or default_pipeline()
        self.deadline_s = deadline_s
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = cooldown_s
        self.audit_negative = bool(audit_negative)
        self.tracer = tracer if tracer is not None else spans.tracer
        # deadline blowouts are never retried (a wedged kernel just burns
        # a second deadline); raised errors get `retries` extra attempts
        self._retry_policy = RetryPolicy(
            max_attempts=1 + max(0, int(retries)),
            base_delay_s=retry_base_delay_s,
            max_delay_s=2.0,
            jitter=0.5,
            retryable=lambda e: not isinstance(e, DeviceDeadlineExceeded),
        )
        self._dispatcher = _DeadlineDispatcher(cuda_index=_cuda_index(device))
        self._time = time_fn
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED  # guarded-by: _lock
        self._consecutive_failures = 0  # guarded-by: _lock
        self._opened_at: float | None = None  # guarded-by: _lock
        self._canary_thread_enabled = bool(canary_thread)
        self._canary_thread: threading.Thread | None = None  # guarded-by: _lock
        self._canary_sets = canary_sets
        self._closed = False  # guarded-by: _lock
        self._stop = threading.Event()  # wakes the canary's sleep at close()
        # per calling thread: dispatch-queue wait and audit seconds since
        # its last `take_call_timings()`
        self._timings = threading.local()
        self._log = logging.getLogger("bls-supervisor")
        self._rl = RateLimitedLogger(self._log, interval_s=30.0)
        self.observer.breaker_state(BREAKER_STATE_VALUES[self._state])

    # -- attribute surface ----------------------------------------------------

    def __getattr__(self, name):
        if name == "device":  # not yet set (unpickling, copy): no recursion
            raise AttributeError(name)
        return getattr(self.device, name)

    # -- breaker state machine -------------------------------------------------

    def _transition_locked(self, to: str) -> None:
        if self._state == to:
            return
        frm, self._state = self._state, to
        if to == BREAKER_OPEN:
            self._opened_at = self._time()
        self.observer.breaker_state(BREAKER_STATE_VALUES[to], to=to)
        self._log.warning("circuit breaker %s -> %s", frm, to)
        self._maybe_span_event("bls/breaker_transition", frm=frm, to=to)

    def _record_device_failure(self, reason: str) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if (self._state == BREAKER_CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._transition_locked(BREAKER_OPEN)
                start_canary = self._canary_thread_enabled
            else:
                start_canary = False
        if start_canary:
            self._start_canary_thread()
        # a device failure is what SLO burn state is for: re-evaluate now
        # (rate-limited, never raises)
        slo.poke()

    def _record_device_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0

    def _device_allowed(self) -> bool:
        with self._lock:
            return self._state == BREAKER_CLOSED

    @property
    def breaker_state(self) -> str:
        with self._lock:
            return self._state

    def breaker_snapshot(self) -> dict:
        """State, policy and counters for `/debug/breaker`."""
        with self._lock:
            state = self._state
            failures = self._consecutive_failures
            opened_at = self._opened_at
        doc = {
            "state": state,
            "state_value": BREAKER_STATE_VALUES[state],
            "consecutive_failures": failures,
            "failure_threshold": self.failure_threshold,
            "cooldown_s": self.cooldown_s,
            "deadline_s": self.deadline_s,
            "retries": self._retry_policy.max_attempts - 1,
            "audit_negative": self.audit_negative,
        }
        if opened_at is not None and state != BREAKER_CLOSED:
            doc["open_for_s"] = round(self._time() - opened_at, 3)
        doc["counters"] = self.observer.supervisor_snapshot()
        mesh_snap = getattr(self.device, "mesh_snapshot", None)
        if mesh_snap is not None:
            try:
                m = mesh_snap()
            except Exception:  # pragma: no cover
                m = None
            if m is not None:
                doc["mesh"] = m
        return doc

    # -- canary ----------------------------------------------------------------

    def _build_canary_sets(self):
        """Two known-valid sets, signed by the port's host tier."""
        if self._canary_sets is None:
            from .. import native
            from ..bls.api import DST_G2, PublicKey, SignatureSet

            sets = []
            for i in range(2):
                sk = (i + 1).to_bytes(32, "big")
                msg = bytes([0xCA, i]) + b"\x7e" * 30
                rc_pk, pk = native.sk_to_pk(sk)
                rc_sig, sig = native.sign(sk, msg, DST_G2)
                if rc_pk or rc_sig:
                    raise RuntimeError("the host tier failed to sign the canary sets")
                sets.append(SignatureSet(PublicKey(pk), msg, sig))
            self._canary_sets = sets
        return self._canary_sets

    def _mesh_has_evicted(self) -> bool:
        try:
            fn = getattr(self.device, "mesh_has_evicted", None)
            return bool(fn()) if fn is not None else False
        except Exception:  # pragma: no cover: introspection must not raise
            return False

    def probe(self) -> bool:
        """One canary probe: open → half_open → a device dispatch of a
        known-valid batch; success re-closes the breaker, failure re-opens
        it. Evicted mesh chips are re-admitted first, so the probe
        validates the full mesh: a still-sick chip fails it and is evicted
        again."""
        readmitted = 0
        if self._mesh_has_evicted():
            readmit = getattr(self.device, "mesh_readmit", None)
            if readmit is not None:
                try:
                    readmitted = int(readmit() or 0)
                except Exception:  # pragma: no cover
                    readmitted = 0
        with self._lock:
            was_closed = self._state == BREAKER_CLOSED
            if was_closed and not readmitted:
                return True
            if not was_closed:
                self._transition_locked(BREAKER_HALF_OPEN)
        ok = False
        err: Exception | None = None
        try:
            sets = self._build_canary_sets()
            with self._maybe_span("bls/canary_probe"):
                ok = bool(self._device_call(
                    lambda: self.device.verify_signature_sets(sets), len(sets)))
        except Exception as e:  # noqa: BLE001: any failure keeps it open
            err = e
        self.observer.supervisor_canary_probe(ok)
        with self._lock:
            if ok:
                self._consecutive_failures = 0
                self._transition_locked(BREAKER_CLOSED)
            elif not was_closed:
                self._transition_locked(BREAKER_OPEN)
        if not ok:
            if readmitted and was_closed and not self._mesh_has_evicted():
                # the restored full mesh failed without naming a chip:
                # shrink again rather than serve on a sick full mesh
                evict = getattr(self.device, "mesh_evict", None)
                if evict is not None:
                    try:
                        evict(chip=None, reason="canary_failed")
                    except Exception:  # pragma: no cover
                        self._log.debug("mesh_evict after failed canary errored",
                                        exc_info=True)
            self._rl.warning("canary", "canary probe failed (%s); device stays degraded",
                             err if err is not None else "device returned False")
        elif readmitted:
            self._log.info("canary probe passed; %d mesh chip(s) re-admitted", readmitted)
        else:
            self._log.info("canary probe passed; breaker closed")
        return ok

    def _start_canary_thread(self) -> None:
        with self._lock:
            if self._closed or (self._canary_thread is not None
                                and self._canary_thread.is_alive()):
                return
            t = threading.Thread(target=self._canary_loop, name="bls-canary", daemon=True)
            self._canary_thread = t
        t.start()

    def _canary_loop(self) -> None:
        while True:
            if self._stop.wait(max(0.001, self.cooldown_s)):
                return
            with self._lock:
                if self._closed:
                    return
                state = self._state
            # the loop also outlives a closed breaker while mesh chips
            # remain evicted: re-admission needs a canary too
            if state == BREAKER_CLOSED and not self._mesh_has_evicted():
                return
            try:
                self.probe()
            except Exception:  # pragma: no cover: probe() already guards
                self._log.exception("canary probe crashed")

    # -- spans -----------------------------------------------------------------

    def _maybe_span(self, name: str, **attrs):
        """A span only inside an active lifecycle trace: the supervisor
        runs on flush threads, where a root trace per dispatch would flood
        the trace ring."""
        if self.tracer.context() is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **attrs)

    def _maybe_span_event(self, name: str, **attrs) -> None:
        self.tracer.event(name, **attrs)

    # -- waits and audits --------------------------------------------------------

    def _add_timing(self, key: str, seconds: float) -> None:
        sums = vars(self._timings)  # this thread's own
        sums[key] = sums.get(key, 0.0) + seconds

    def _observe_dispatch_wait(self, seconds: float) -> None:
        self.observer.observe_stage("dispatch_wait", seconds)
        self._add_timing("dispatch_wait_s", seconds)

    def take_call_timings(self) -> dict:
        """The calling thread's dispatch-queue wait seconds
        (`dispatch_wait_s`) and, if an audit ran, audit seconds
        (`audit_s`) since its last take; both start again from zero."""
        sums = vars(self._timings)
        out = {"dispatch_wait_s": round(sums.pop("dispatch_wait_s", 0.0), 6)}
        if "audit_s" in sums:
            out["audit_s"] = round(sums.pop("audit_s"), 6)
        return out

    # -- dispatch --------------------------------------------------------------

    def _evict_sick_host(self, exc, n_sets: int, reason: str) -> bool:
        """The fleet half of the policy: a failure that names a whole host
        (`exc.host`, as `MeshWorkerError` does when every worker of a host
        is down or silent) evicts that host from the two-level mesh and
        the call is retried on the survivors, spending no retry and
        feeding no breaker. True when a host was evicted."""
        host = getattr(exc, "host", None)
        if host is None:
            return False
        evict = getattr(self.device, "mesh_evict_host", None)
        if evict is None:
            return False
        try:
            new_size = evict(host=host, reason=reason)
        except Exception:  # pragma: no cover: eviction must never mask
            return False
        if new_size is None:
            return False
        self._maybe_span_event("bls/fleet_host_eviction", reason=reason, new_size=new_size)
        self._rl.warning("fleet_evict", "fleet host evicted (%s); retrying %d sets on the "
                         "surviving %d-chip mesh", reason, n_sets, max(new_size, 1))
        if self._canary_thread_enabled:
            self._start_canary_thread()
        return True

    def _evict_sick_chip(self, exc, n_sets: int, reason: str) -> bool:
        """The mesh half of the policy: a failed dispatch evicts the suspect
        chip (the one the exception names, `exc.chip`, else the
        dispatcher's choice) and the call is retried at once on the
        survivors, spending no retry and feeding no breaker. The canary
        re-admits once probes pass. True when a chip was evicted."""
        evict = getattr(self.device, "mesh_evict", None)
        if evict is None:
            return False
        try:
            new_size = evict(chip=getattr(exc, "chip", None), reason=reason)
        except Exception:  # pragma: no cover: eviction must never mask
            return False
        if new_size is None:
            return False
        self._maybe_span_event("bls/mesh_eviction", reason=reason, new_size=new_size)
        self._rl.warning("mesh_evict", "mesh chip evicted (%s); retrying %d sets on the "
                         "surviving %d-chip mesh", reason, n_sets, max(new_size, 1))
        if self._canary_thread_enabled:
            self._start_canary_thread()
        return True

    def _device_call(self, fn, n_sets: int):
        """One supervised device call: deadline-bounded, one jittered retry
        for raised errors, eviction retries while a mesh has chips to
        lose (`mesh_evict` returns None once nothing is left). Raises on
        final failure."""
        attempts = self._retry_policy.max_attempts
        attempt = 0
        while True:
            try:
                return self._dispatcher.run(fn, self.deadline_s, self._observe_dispatch_wait)
            except DeviceDeadlineExceeded:
                self.observer.supervisor_deadline()
                self._rl.error("deadline", "device dispatch (%d sets) blew the %.1fs deadline; "
                               "worker abandoned", n_sets, self.deadline_s)
                # a wedged chip is a sick chip: shrink the mesh and retry
                # on the survivors; without a mesh, never retried
                if self._evict_sick_chip(None, n_sets, "deadline"):
                    continue
                raise
            except Exception as e:
                if self._evict_sick_host(e, n_sets, type(e).__name__):
                    continue
                if self._evict_sick_chip(e, n_sets, type(e).__name__):
                    continue
                attempt += 1
                if attempt >= attempts:
                    raise
                self.observer.supervisor_retry()
                self._rl.warning("retry", "device dispatch failed (%s: %s); retrying once with "
                                 "backoff", type(e).__name__, e)
                self._retry_policy.sleep(self._retry_policy.delay_s(attempt - 1))

    def _cpu_fallback(self, fn, reason: str, n_sets: int, default):
        """Serve from the host tier; only its failure on top of a device
        failure gives the blanket `default` (False) verdicts."""
        self.observer.supervisor_fallback(reason, n_sets)
        if reason != "negative_audit":  # audits are the healthy path, not outages
            self._rl.warning("fallback:" + reason, "device tier unavailable (%s); serving %d "
                             "sets from the host tier", reason, n_sets)
        try:
            with self._maybe_span("bls/cpu_fallback", reason=reason):
                if reason == "negative_audit":
                    return self._audit(fn)
                return fn()
        except Exception:
            self.observer.both_tiers_failed()
            self._log.exception("both_tiers_failed: the host tier failed after a device "
                                "failure (%s); resolving %d sets as invalid", reason, n_sets)
            return default

    def _audit(self, fn):
        """The host tier's audit of a device False: its seconds are stage
        `audit`, inside the profiler scope `bls/audit` (where PyTorch is
        loaded: a host-only process stays without it)."""
        scope = contextlib.nullcontext()
        if "torch" in sys.modules:
            from ..observability import trace

            scope = trace.annotation("bls/audit")
        t0 = time.monotonic()
        try:
            with scope:
                return fn()
        finally:
            seconds = time.monotonic() - t0
            self.observer.observe_stage("audit", seconds)
            self._add_timing("audit_s", seconds)

    # -- IBlsVerifier ----------------------------------------------------------

    def verify_signature_sets(self, sets) -> bool:
        sets = list(sets)
        if not sets:
            return False
        cpu = lambda: self.cpu.verify_signature_sets(sets)  # noqa: E731
        if not self._device_allowed():
            return self._cpu_fallback(cpu, "breaker_open", len(sets), False)
        try:
            with self._maybe_span("bls/supervised_batch", sets=len(sets)):
                verdict = bool(self._device_call(
                    lambda: self.device.verify_signature_sets(sets), len(sets)))
        except DeviceDeadlineExceeded:
            self._record_device_failure("deadline")
            return self._cpu_fallback(cpu, "deadline", len(sets), False)
        except Exception:
            self._record_device_failure("exception")
            self._log.exception("device batch dispatch failed after retry; falling back to the "
                                "host tier")
            return self._cpu_fallback(cpu, "exception", len(sets), False)
        if verdict:
            self._record_device_success()
            return True
        if not self.audit_negative:
            self._record_device_success()
            return False
        # negative-verdict audit: a device False rejects blocks, so the
        # host tier confirms it (free while every batch is valid; an
        # overturned verdict is evidence of a flaky device)
        cpu_verdict = self._cpu_fallback(lambda: bool(cpu()), "negative_audit", len(sets), False)
        if cpu_verdict:
            self.observer.verdict_mismatch()
            self._record_device_failure("verdict_mismatch")
            self._rl.error("mismatch", "device reported a batch of %d sets invalid but the host "
                           "tier verified it: flaky device verdicts", len(sets))
        else:
            self._record_device_success()
        return cpu_verdict

    def verify_signature_sets_individual(self, sets) -> list[bool]:
        sets = list(sets)
        if not sets:
            return []
        cpu = lambda: self.cpu.verify_signature_sets_individual(sets)  # noqa: E731
        none = [False] * len(sets)
        if not self._device_allowed():
            return self._cpu_fallback(cpu, "breaker_open", len(sets), none)
        try:
            with self._maybe_span("bls/supervised_individual", sets=len(sets)):
                verdicts = list(self._device_call(
                    lambda: self.device.verify_signature_sets_individual(sets), len(sets)))
        except DeviceDeadlineExceeded:
            self._record_device_failure("deadline")
            return self._cpu_fallback(cpu, "deadline", len(sets), none)
        except Exception:
            self._record_device_failure("exception")
            self._log.exception("device individual dispatch failed after retry; falling back "
                                "to the host tier")
            return self._cpu_fallback(cpu, "exception", len(sets), none)
        self._record_device_success()
        out = [bool(v) for v in verdicts]
        rejected = [i for i, v in enumerate(out) if not v]
        if not self.audit_negative or not rejected:
            return out
        # audit only the rejected sets on the host tier
        audited = self._cpu_fallback(
            lambda: self.cpu.verify_signature_sets_individual([sets[i] for i in rejected]),
            "negative_audit", len(rejected), [False] * len(rejected))
        overturned = 0
        for i, cpu_v in zip(rejected, audited):
            if cpu_v:
                overturned += 1
                out[i] = True
        if overturned:
            self.observer.verdict_mismatch(overturned)
            self._record_device_failure("verdict_mismatch")
            self._rl.error("mismatch", "device rejected %d/%d sets the host tier verified: "
                           "flaky device verdicts", overturned, len(sets))
        return out

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Stop the canary thread (joined, so no probe touches the card
        after this returns) and release the dispatch worker."""
        with self._lock:
            self._closed = True
            canary = self._canary_thread
        self._stop.set()
        if canary is not None and canary is not threading.current_thread():
            canary.join((self.deadline_s or 0) + 10.0)
        self._dispatcher.close()
