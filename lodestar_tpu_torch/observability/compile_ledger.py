"""Process-wide build and first-launch accounting, and the cold-start
timeline (the JAX package's `observability/compile_ledger.py`).

What compiles in the port is not a jitted graph but its shared
libraries, built from the checkout's sources at first use
(`build.build_shared`), and what the first call of a verdict pays is
that build, the library's load and the first launch, which maps the
kernel's code lazily (a 2 MiB granule on the H100). This module makes
each a measured event:

- `build.build_shared` records one event per library (kernel
  `build/<name>`, key the source digest) with its cache outcome: `hit`,
  the digest-named `.so` was already in the build directory; `miss`, it
  was compiled now. `compile_start` goes to the flight recorder before
  the compiler runs, so a build that hangs is identifiable as
  started-but-unfinished.
- `CompileLedger.wrap(fn, kernel)` wraps a verdict callable at its seam
  (`TorchBlsVerifier`, `EpochPubkeyTable.gather_device`). The FIRST call
  per (kernel, signature) is timed on the host clock (no device
  synchronisation) and recorded; every later call goes straight through
  with one set lookup. Its cache outcome compares the build directory
  before and after the call, as the JAX ledger compares its compile
  cache: `miss`, a library was built during the call; `hit`, the
  directory exists and nothing new appeared; `off`, there is no build
  directory.
- Events tick the `lodestar_tpu_compile_*` families of every live
  `PipelineMetrics` (each attaches itself by weakref), feed the flight
  recorder and the `snapshot()` document, and persist through
  `write_artifact`.

The AOT half of the JAX ledger (`preload_aot`, `note_aot`, the
executable overrides) waits for the port's warm boot; its snapshot
section reads empty and `lodestar_tpu_aot_events_total` stays at zero.
Nor is `note_prune`: the port has no pruner of its build directory.

`StartupTimeline` is the getting-to-serving half: `mark(phase)` records
seconds since PROCESS start (anchored via /proc/self/stat field 22 so
Python import time is included; falls back to module-import time) into
the `lodestar_tpu_startup_phase_seconds` gauge, and
`mark_serving_ready()` sets the `lodestar_tpu_serving_ready_seconds`
gauge.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
import time
import weakref

from . import flight_recorder

__all__ = [
    "CompileLedger",
    "StartupTimeline",
    "ledger",
    "timeline",
]

MAX_LEDGER_EVENTS = 512

_IMPORT_MONOTONIC = time.monotonic()


def _shape_key(args, kwargs) -> str:
    """Positional/keyword argument signature: dtype[shape] per tensor or
    array argument (anything without `.shape` contributes its type
    name)."""
    parts = []
    for a in list(args) + [v for _, v in sorted(kwargs.items())]:
        shape = getattr(a, "shape", None)
        if shape is not None:
            dims = "x".join(str(d) for d in shape)
            parts.append(f"{getattr(a, 'dtype', '?')}[{dims}]")
        else:
            parts.append(type(a).__name__)
    return ",".join(parts)


def _device_key() -> str:
    """`<platform>x<count>` fingerprint of the visible device set."""
    import torch

    if torch.cuda.is_available():
        return f"cudax{torch.cuda.device_count()}"
    return "cpux1"


def _cache_dir() -> str | None:
    """The build directory when it exists, else None."""
    from ..build import BUILD_DIR

    return BUILD_DIR if BUILD_DIR and os.path.isdir(BUILD_DIR) else None


def _cache_listing(cache_dir: str | None) -> frozenset:
    if not cache_dir:
        return frozenset()
    try:
        return frozenset(os.listdir(cache_dir))
    except OSError:
        return frozenset()


class CompileLedger:
    """Append-only (bounded) record of compile events + the wrap seam."""

    def __init__(self, max_events: int = MAX_LEDGER_EVENTS):
        self._lock = threading.Lock()
        self._max_events = max_events
        self._events: list[dict] = []  # guarded-by: _lock
        self._seen: set = set()  # guarded-by: _lock
        self._cumulative_s = 0.0  # guarded-by: _lock
        self._counts = {"hit": 0, "miss": 0, "off": 0}  # guarded-by: _lock
        self._pipelines: list = []  # guarded-by: _lock
        self._entries_at_start: int | None = None  # guarded-by: _lock

    # -- pipeline fan-out ---------------------------------------------------

    def attach(self, pipeline) -> None:
        """Weakref-register a PipelineMetrics so ledger events tick its
        `lodestar_tpu_compile_*` families (PipelineMetrics.__init__ calls
        this; dead refs are compacted on every attach)."""
        with self._lock:
            self._pipelines = [r for r in self._pipelines if r() is not None]
            self._pipelines.append(weakref.ref(pipeline))

    def pipelines(self) -> list:
        """Every still-live attached PipelineMetrics."""
        with self._lock:
            refs = list(self._pipelines)
        return [p for p in (r() for r in refs) if p is not None]

    # -- the wrap seam ------------------------------------------------------

    def wrap(self, fn, kernel: str, static_key: str | None = None):
        """Wrap a verdict callable: the first call per (kernel, signature)
        is timed and recorded as one event; later calls pass straight
        through. `static_key` replaces the per-call shape key when the
        caller already knows the one signature the callable will see."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            key = static_key if static_key is not None else _shape_key(args, kwargs)
            with self._lock:
                fresh = (kernel, key) not in self._seen
                if fresh:
                    # marked BEFORE the call: a concurrent second caller
                    # must not record the same first call twice
                    self._seen.add((kernel, key))
            if not fresh:
                return fn(*args, **kwargs)
            return self._timed_first_call(fn, kernel, key, args, kwargs)

        wrapped.__compile_ledger_kernel__ = kernel
        return wrapped

    def _timed_first_call(self, fn, kernel, key, args, kwargs):
        cache_dir = _cache_dir()
        self._ensure_cache_baseline(cache_dir)
        before = _cache_listing(cache_dir)
        # compile_start lands in the flight recorder BEFORE the call: a
        # build that hangs past a watchdog is identifiable in the
        # post-mortem as started-but-unfinished
        flight_recorder.record("compile_start", kernel=kernel, key=key)
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        duration_s = time.monotonic() - t0
        cache_dir = cache_dir or _cache_dir()
        if cache_dir is None:
            cache = "off"
        elif _cache_listing(cache_dir) - before:
            cache = "miss"
        else:
            cache = "hit"
        self.record(kernel, key, duration_s, cache)
        return out

    # -- recording ----------------------------------------------------------

    def record(self, kernel: str, key: str, duration_s: float,
               cache: str = "off") -> dict:
        """Append one compile event and fan it out (metrics + flight
        recorder). Public so seams that time compiles themselves (the
        library builds, tests) feed the same ledger."""
        event = {
            "kernel": kernel,
            "key": key,
            "device_set": _device_key(),
            "seconds": round(duration_s, 4),
            "cache": cache,
        }
        with self._lock:
            self._events.append(event)
            if len(self._events) > self._max_events:
                del self._events[0]
            self._cumulative_s += duration_s
            self._counts[cache] = self._counts.get(cache, 0) + 1
            cumulative = self._cumulative_s
        flight_recorder.record(
            "compile_end", kernel=kernel, key=key,
            seconds=event["seconds"], cache=cache,
        )
        for p in self.pipelines():
            p.compile_event(kernel, cache, duration_s, cumulative)
        return event

    # -- export -------------------------------------------------------------

    def _ensure_cache_baseline(self, cache_dir: str | None) -> None:
        """Record the build directory's entry count once, before the first
        build touches it: the cold/warm classifier of a run."""
        if cache_dir is None:
            return
        with self._lock:
            known = self._entries_at_start is not None
        if known:
            return
        n = len(_cache_listing(cache_dir))
        with self._lock:
            if self._entries_at_start is None:
                self._entries_at_start = n

    def snapshot(self) -> dict:
        """The `/debug/compiles` document."""
        cache_dir = _cache_dir()
        self._ensure_cache_baseline(cache_dir)
        device = _device_key()
        entries_now = len(_cache_listing(cache_dir)) if cache_dir else None
        with self._lock:
            events = list(self._events)
            doc = {
                "device_set": device,
                "event_count": len(events),
                "cumulative_seconds": round(self._cumulative_s, 4),
                "cache": {
                    "dir": cache_dir,
                    "entries_at_start": self._entries_at_start,
                    "entries_now": entries_now,
                    "hits": self._counts.get("hit", 0),
                    "misses": self._counts.get("miss", 0),
                    "uncached": self._counts.get("off", 0),
                    "aot_hits": 0,
                },
                # the AOT half is not ported: its section reads empty
                "aot": {
                    "store": None,
                    "load": False,
                    "export": False,
                    "loaded_executables": 0,
                    "counts": {},
                    "events": [],
                },
                "events": events,
            }
        if cache_dir is None:
            state = "off"
        elif not doc["cache"]["entries_at_start"]:
            state = "cold"
        else:
            state = "warm"
        doc["cache"]["state"] = state
        return doc

    def write_artifact(self, path: str) -> str | None:
        """Persist the snapshot as `compile_ledger.json`; never raises:
        the artifact write must not fail a report."""
        try:
            with open(path, "w") as f:
                json.dump(self.snapshot(), f, indent=2)
            return path
        except OSError as e:
            print(f"compile_ledger: artifact write failed: {e}",
                  file=sys.stderr)
            return None


_ledger: CompileLedger | None = None
_ledger_lock = threading.Lock()


def ledger() -> CompileLedger:
    """The process-wide ledger every build and first-call seam records
    into."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = CompileLedger()
        return _ledger


# -- startup timeline -------------------------------------------------------


def _process_start_monotonic() -> float:
    """The monotonic timestamp of PROCESS start (so interpreter + import
    time count toward serving-ready): /proc/self/stat field 22
    (starttime, clock ticks since boot) against /proc/uptime. Falls back
    to this module's import time off Linux."""
    try:
        with open("/proc/self/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # fields after the parenthesized comm (which may contain spaces);
        # starttime is overall field 22 == index 19 of the tail
        tail = stat.rsplit(")", 1)[1].split()
        start_ticks = float(tail[19])
        hz = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime_s = float(f.read().split()[0])
        age_s = uptime_s - start_ticks / hz
        if age_s < 0:
            return _IMPORT_MONOTONIC
        return time.monotonic() - age_s
    except (OSError, ValueError, IndexError):
        return _IMPORT_MONOTONIC


class StartupTimeline:
    """Phase marks measured from process start; feeds the startup-phase
    and serving-ready gauges on every live pipeline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._start = _process_start_monotonic()
        self._marks: list[dict] = []  # guarded-by: _lock
        self._serving_ready_s: float | None = None  # guarded-by: _lock

    def mark(self, phase: str) -> float:
        """Record `phase` at now-since-process-start seconds."""
        t_s = time.monotonic() - self._start
        with self._lock:
            self._marks.append({"phase": phase, "t_s": round(t_s, 3)})
        flight_recorder.record("startup", phase=phase,
                               since_start_s=round(t_s, 3))
        for p in ledger().pipelines():
            p.startup_phase(phase, t_s)
        return t_s

    def mark_serving_ready(self) -> float:
        """The SLO mark: the process can serve its verdicts from here on."""
        t_s = self.mark("serving_ready")
        with self._lock:
            self._serving_ready_s = t_s
        for p in ledger().pipelines():
            p.serving_ready(t_s)
        return t_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "marks": list(self._marks),
                "serving_ready_s": (
                    round(self._serving_ready_s, 3)
                    if self._serving_ready_s is not None
                    else None
                ),
            }


_timeline: StartupTimeline | None = None
_timeline_lock = threading.Lock()


def timeline() -> StartupTimeline:
    """The process-wide startup timeline."""
    global _timeline
    with _timeline_lock:
        if _timeline is None:
            _timeline = StartupTimeline()
        return _timeline
