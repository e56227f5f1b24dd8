"""Node-wide lifecycle tracing: slot-milestone spans from the gossip wire
to the head update (the JAX package's `observability/spans.py`).

Each gossip message or direct block import becomes one **trace**: a root
span plus nested child spans (decode, validation, signature
verification, fork choice, import). Traces carry a trace id, spans a
parent id, and the active span propagates through `contextvars`: spans
opened in asyncio tasks (the context is copied at task creation) and in
executor threads (the explicit `context()` / `attach()` hand-off, since
`run_in_executor` and `ThreadPoolExecutor` do NOT copy the context) land
in the same trace.

Finished traces go to a bounded ring (256 by default); the metrics
server's `/debug/traces` serves them as JSON, filterable by slot and
block root, and `on_finish` callbacks see each one (the serving stack
counts them into `lodestar_lifecycle_traces_total`). While a
`torch.profiler` runs (the switch of `observability/trace.py`, or one an
operator started), each span also opens a
`record_function("lifecycle/<name>")` scope, so lifecycle spans share a
timeline with the verdicts' stage scopes.

Zero cost when disabled: `span()` and `trace()` return one shared no-op
singleton (no allocation, no clock read, no ring write). A tracer is
enabled unless constructed with `enabled=False` (the JAX registry's
LODESTAR_TPU_TRACE_LIFECYCLE default, True; nothing is read from the
process environment) or `tracer.enabled` is set False.
"""

from __future__ import annotations

import contextlib
import contextvars
import importlib
import logging
import os
import sys
import threading
import time
from collections import deque

_log = logging.getLogger(__name__)


def _profiling_trace():
    """The `trace` module while a `torch.profiler` runs, else None: the
    program's own switch (`trace.start_profiling`) or a profiler an
    operator or a benchmark started. A process that has not loaded
    PyTorch runs no profiler, so spans (and the log filter that reads
    their ids) leave PyTorch unloaded there."""
    # the process-wide flag every `torch.profiler` start sets
    running = getattr(sys.modules.get("torch.autograd.profiler"), "_is_profiler_enabled", False)
    return importlib.import_module(f"{__package__}.trace") if running else None


# milestones recorded against the start of a block's slot
MILESTONES = (
    "block_received",   # gossip wire bytes decoded
    "validated",        # gossip validation ladder ACCEPTed
    "sigs_verified",    # block signature batch verdict resolved
    "imported",         # fork choice + caches + db updated
    "head_updated",     # the block became (part of) the canonical head
)

# the JAX registry's LODESTAR_TPU_TRACE_LIFECYCLE default
TRACE_LIFECYCLE = True
CAPACITY = 256

_current: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "lodestar_tpu_torch_lifecycle_span", default=None
)


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self


_NULL = _NullSpan()


class Span:
    """One timed section of a trace. Context manager only; entering sets
    the context variable, so nested `tracer.span()` calls become
    children."""

    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_id", "attrs",
        "events", "t0", "t0_wall", "duration_s", "status", "_root",
        "_token", "_annotation", "_records", "_rec_lock",
    )

    def __init__(self, tracer: "Tracer", name: str, root: "Span | None",
                 parent: "Span | None", attrs: dict):
        self.tracer = tracer
        self.name = name
        self.span_id = os.urandom(4).hex()
        self.attrs = dict(attrs)
        self.events: list[dict] = []
        self.duration_s = None
        self.status = "ok"
        self._token = None
        self._annotation = None
        if root is None:  # this span is a trace root
            self._root = self
            self.trace_id = os.urandom(8).hex()
            self.parent_id = None
            self._records: list[dict] = []
            self._rec_lock = threading.Lock()
        else:
            self._root = root
            self.trace_id = root.trace_id
            self.parent_id = parent.span_id if parent is not None else root.span_id
            self._records = root._records
            self._rec_lock = root._rec_lock
            # creation-time attributes promote like annotate(), so a child
            # span makes the whole trace filterable
            for key in ("slot", "root", "kind"):
                if key in self.attrs and key not in root.attrs:
                    root.attrs[key] = self.attrs[key]

    # -- recording helpers ----------------------------------------------------

    def annotate(self, **attrs) -> "Span":
        """Attach attributes; `slot`, `root` and `kind` also promote to the
        trace root, so the whole trace is filterable by them."""
        self.attrs.update(attrs)
        root = self._root
        if root is not self:
            for key in ("slot", "root", "kind"):
                if key in attrs and key not in root.attrs:
                    root.attrs[key] = attrs[key]
        return self

    def event(self, name: str, **attrs) -> "Span":
        ev = {"name": name, "t_s": round(time.monotonic() - self._root.t0, 6)}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)
        return self

    # -- lifecycle ------------------------------------------------------------

    def __enter__(self) -> "Span":
        self.t0 = time.monotonic()
        if self._root is self:
            self.t0_wall = time.time()
        self._token = _current.set(self)
        trace = _profiling_trace()
        if trace is not None:
            # onto the profiler's timeline beside the verdicts' stage scopes
            self._annotation = trace.annotation(f"lifecycle/{self.name}")
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                # exited in another context than it entered (cross-thread
                # misuse): clear rather than corrupt the other context
                _current.set(None)
            self._token = None
        self.duration_s = time.monotonic() - self.t0
        if exc_type is not None:
            self.status = "error"
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        rec = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": round(self.t0 - self._root.t0, 6),
            "duration_s": round(self.duration_s, 6),
        }
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        if self.events:
            rec["events"] = list(self.events)
        if self.status != "ok":
            rec["status"] = self.status
        with self._rec_lock:
            self._records.append(rec)
        if self._root is self:
            self.tracer._finish(self)
        return False


class Tracer:
    """Trace factory and bounded retention ring.

    `trace(name)` opens a new root; `span(name)` nests under the current
    span (opening a fresh root when none is active, so a direct import
    still produces one trace per block)."""

    def __init__(self, capacity: int = CAPACITY, enabled: bool = TRACE_LIFECYCLE):
        self.enabled = enabled
        self.capacity = capacity
        self._ring: deque[dict] = deque(maxlen=capacity)  # guarded-by: _lock
        self._lock = threading.Lock()
        self.completed_total = 0  # guarded-by: _lock
        # callbacks(trace_doc): the serving stack counts finished traces
        # into its lifecycle counter here
        self.on_finish: list = []

    # -- span creation --------------------------------------------------------

    def trace(self, name: str, **attrs):
        if not self.enabled:
            return _NULL
        return Span(self, name, root=None, parent=None, attrs=attrs)

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL
        cur = _current.get()
        if cur is None or isinstance(cur, _NullSpan):
            return Span(self, name, root=None, parent=None, attrs=attrs)
        return Span(self, name, root=cur._root, parent=cur, attrs=attrs)

    # -- cross-thread propagation ---------------------------------------------

    def context(self) -> "Span | None":
        """The live span to hand to another thread (`run_in_executor` and
        `ThreadPoolExecutor` do NOT copy context variables)."""
        if not self.enabled:
            return None
        return _current.get()

    @contextlib.contextmanager
    def attach(self, span: "Span | None"):
        """Re-establish `span` as current inside a worker thread."""
        if span is None or isinstance(span, _NullSpan) or not self.enabled:
            yield None
            return
        token = _current.set(span)
        try:
            yield span
        finally:
            try:
                _current.reset(token)
            except ValueError:
                _current.set(None)

    # -- in-flight annotation -------------------------------------------------

    def annotate(self, **attrs) -> None:
        cur = _current.get()
        if cur is not None:
            cur.annotate(**attrs)

    def event(self, name: str, **attrs) -> None:
        cur = _current.get()
        if cur is not None:
            cur.event(name, **attrs)

    def current_trace_id(self) -> str | None:
        cur = _current.get()
        return None if cur is None else cur.trace_id

    # -- retention and query --------------------------------------------------

    def _finish(self, root: Span) -> None:
        with root._rec_lock:
            spans = sorted(root._records, key=lambda r: r["start_s"])
        doc = {
            "trace_id": root.trace_id,
            "name": root.name,
            "ts": round(root.t0_wall, 3),
            "duration_s": round(root.duration_s, 6),
            "slot": root.attrs.get("slot"),
            "root": root.attrs.get("root"),
            "spans": spans,
        }
        if root.attrs:
            doc["attrs"] = dict(root.attrs)
        with self._lock:
            self._ring.append(doc)
            self.completed_total += 1
        for cb in list(self.on_finish):
            try:
                cb(doc)
            except Exception:
                # observers must never break the traced path
                _log.debug("on_finish observer failed", exc_info=True)

    def traces(self, slot=None, root=None, limit: int = 64) -> list[dict]:
        """Recent traces, newest first, optionally filtered by slot or
        block root (hex, with or without 0x)."""
        if root is not None:
            root = root.lower().removeprefix("0x")
        with self._lock:
            docs = list(self._ring)
        out = []
        for doc in reversed(docs):
            if slot is not None and doc.get("slot") != slot:
                continue
            if root is not None:
                have = doc.get("root")
                if not have or have.lower().removeprefix("0x") != root:
                    continue
            out.append(doc)
            if len(out) >= limit:
                break
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# the process-wide default: the supervisor and the serving stack use this
# instance, so every layer lands in one ring (tests build their own)
tracer = Tracer()


def span(name: str, **attrs):
    return tracer.span(name, **attrs)


def current_trace_id() -> str | None:
    return tracer.current_trace_id()


def record_slot_milestone(chain, milestone: str, slot: int) -> float:
    """Observe `milestone` for `slot` as a delay from the slot's start:
    the histogram and last-value gauge of the chain's metrics bundle (when
    it has them), plus an event on the current trace. Returns the delay."""
    delay = chain.clock.time_fn() - chain.clock.time_at_slot(int(slot))
    m = getattr(chain, "metrics", None)
    if m is not None and hasattr(m, "slot_milestone_seconds"):
        m.slot_milestone_seconds.observe(delay, milestone=milestone)
        m.slot_milestone_last.set(delay, milestone=milestone)
    tracer.event(milestone, slot=int(slot), delay_s=round(delay, 4))
    return delay
