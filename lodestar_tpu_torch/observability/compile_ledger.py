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
- The ahead-of-time half: the build directory is the store of
  `ops/aot_store.py` (each library with a header holding its build
  fingerprint and checksum), and `note_aot` counts what the store
  answered each lookup with the JAX outcome names: `hit` (verified and
  opened), `miss` (not there), `corrupt` (a damaged library or header,
  moved aside, never opened), `version_mismatch` (another toolchain,
  torch or card; moved aside), `export` (a build saved with its header).
  `preload_aot()` opens every serving library of the store at boot and,
  on a card, launches each kernel once on one lane (K1, K4, K2, K2p, K3,
  K3-fe), so that the lazy loading of each kernel's module is paid before
  the first verdict; the warm-boot ladder and every mesh worker call it.
  `note_prune` records what the store's pruner removed.
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

The JAX ledger's executable overrides have no counterpart: a library,
once opened, serves every call of its kernels.

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


def _store_dir() -> str:
    from ..build import BUILD_DIR

    return os.path.abspath(BUILD_DIR)


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
        self._last_prune: dict | None = None  # guarded-by: _lock
        self._entries_at_start: int | None = None  # guarded-by: _lock
        self._aot_counts: dict = {}  # guarded-by: _lock
        self._aot_events: list[dict] = []  # guarded-by: _lock
        self._aot_last: dict[str, str] = {}  # kernel -> last outcome; guarded-by: _lock
        self._aot_loaded: set = set()  # kernels opened from the store; guarded-by: _lock
        self._launched: dict[str, float] = {}  # first-launch seconds; guarded-by: _lock
        self._aot_marked = False  # guarded-by: _lock (aot_load phase once)

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

    # -- the ahead-of-time store ----------------------------------------------

    def note_aot(self, kernel: str, key: str, outcome: str,
                 seconds: float = 0.0, detail: str | None = None) -> dict:
        """One store event (hit/miss/corrupt/version_mismatch/export):
        bounded event list, flight recorder, and the
        `lodestar_tpu_aot_events_total` family on every live pipeline."""
        event = {
            "kernel": kernel,
            "key": key,
            "outcome": outcome,
            "seconds": round(seconds, 4),
        }
        if detail:
            event["detail"] = str(detail)[:200]
        with self._lock:
            self._aot_events.append(event)
            if len(self._aot_events) > self._max_events:
                del self._aot_events[0]
            self._aot_counts[outcome] = self._aot_counts.get(outcome, 0) + 1
            self._aot_last[kernel] = outcome
            if outcome == "hit":
                self._aot_loaded.add(kernel)
        flight_recorder.record(
            "aot", kernel=kernel, key=key, outcome=outcome,
            seconds=event["seconds"],
        )
        for p in self.pipelines():
            p.aot_event(kernel, outcome)
        return event

    def preload_aot(self, kernels=None, device=None) -> dict:
        """Open every serving library of the store (`build.SERVING` for
        the device's type: the host tier, and on a card K1's, K4's and the
        tower kernels') whose header, fingerprint and checksum verify; a
        library the store refuses is counted and left to its first use,
        which rebuilds it (nothing is compiled here). On a card, launch
        each kernel of the opened libraries once on one lane of zeros (K1,
        K4, K2, K2p, K3, K3-fe; once per process), so the lazy loading of
        its module is paid now. `kernels` restricts the libraries by name;
        `device` defaults to the current card, else the CPU. Marks
        `aot_load` on the startup timeline once libraries were opened.
        Returns the JAX summary (`loaded`, `skipped`, `seconds`) with each
        library's `outcomes` and `load_seconds`, each kernel's
        `launch_seconds` and the `device`; never raises for a refused
        library."""
        import torch

        from .. import build

        t_start = time.monotonic()
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        summary: dict = {"loaded": [], "skipped": 0, "outcomes": {}, "load_seconds": {},
                         "launch_seconds": {}, "device": str(dev)}
        for name in build.SERVING[dev.type]:
            if kernels is not None and name not in kernels:
                continue
            if name in build._LIBS:  # already open in this process
                summary["skipped"] += 1
                continue
            t0 = time.monotonic()
            try:
                lib = build.load(name, build=False, ledger=self)
                with self._lock:
                    summary["outcomes"][name] = self._aot_last.get(f"build/{name}")
            except build.BuildError:  # no compiler: nothing can be verified
                lib, summary["outcomes"][name] = None, "no_compiler"
            summary["load_seconds"][name] = round(time.monotonic() - t0, 6)
            if lib is None:
                summary["skipped"] += 1
            else:
                summary["loaded"].append(f"build/{name}:{build.LIBRARIES[name].digest()}")
        with self._lock:
            first = bool(summary["loaded"]) and not self._aot_marked
            self._aot_marked = self._aot_marked or first
        if first:
            timeline().mark("aot_load")
        if dev.type == "cuda":
            summary["launch_seconds"] = self._first_launches(dev)
        summary["seconds"] = round(time.monotonic() - t_start, 3)
        return summary

    def _first_launches(self, dev) -> dict:
        """Launch each kernel of an open library once on one lane of zeros
        (every kernel takes a zero lane), each timed with the host clock to
        the end of a device synchronisation; a kernel launched before in
        this process is not launched again."""
        import torch

        from .. import build
        from ..ops import cuda_fp, cuda_mxu, cuda_tower

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        p, q = (1, 32), (1, 2, 32)
        launches = (
            ("K1", "mont_mul", cuda_fp.mont_mul_cuda, (p, p)),
            ("K4", "mxu_mont", cuda_mxu.mont_mul_mxu_cuda, (p, p)),
            ("K2", "tower", cuda_tower.miller_loop_cuda, (p, p, q, q)),
            ("K2p", "tower", cuda_tower.miller_loop_proj_cuda, (p, p, p, q, q, q)),
            ("K3", "tower", cuda_tower.pairing_fused_cuda, (p, p, q, q, q, q)),
            ("K3-fe", "tower", cuda_tower.final_exp_cuda, ((1,) + cuda_tower.FP12_SHAPE,)),
        )
        out = {}
        with torch.cuda.device(dev):
            for kernel, lib, fn, shapes in launches:
                with self._lock:
                    done = kernel in self._launched
                if done or lib not in build._LIBS:
                    continue
                args = [z(*s) for s in shapes]
                torch.cuda.synchronize(dev)
                t0 = time.monotonic()
                fn(*args)
                torch.cuda.synchronize(dev)
                out[kernel] = round(time.monotonic() - t0, 6)
                with self._lock:
                    self._launched[kernel] = out[kernel]
                flight_recorder.record("first_launch", kernel=kernel, seconds=out[kernel])
        return out

    def note_prune(self, result: dict) -> None:
        """Record the store's last prune (`AotStore.prune`) so the snapshot
        carries it; ticks the cache gauges on every live pipeline."""
        remaining = result.get(
            "entries_remaining",
            result.get("entries", 0) - len(result.get("removed", ())),
        )
        rec = {
            "entries": result.get("entries", 0),
            "entries_remaining": remaining,
            "removed": len(result.get("removed", ())),
            "removed_bytes": result.get("removed_bytes", 0),
            "total_bytes": result.get("total_bytes", 0),
            "unix_time": round(time.time(), 1),
        }
        with self._lock:
            self._last_prune = rec
        flight_recorder.record(
            "cache_prune",
            removed=rec["removed"], removed_bytes=rec["removed_bytes"],
        )
        for p in self.pipelines():
            p.cache_pruned(rec["removed_bytes"], remaining)

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
                    "aot_hits": self._aot_counts.get("hit", 0),
                },
                # the store always loads and always exports: the port has
                # no switch for either
                "aot": {
                    "store": _store_dir(),
                    "load": True,
                    "export": True,
                    "loaded_executables": len(self._aot_loaded),
                    "counts": dict(self._aot_counts),
                    "events": list(self._aot_events),
                },
                "events": events,
            }
            last_prune = self._last_prune
        if cache_dir is None:
            state = "off"
        elif not doc["cache"]["entries_at_start"]:
            state = "cold"
        else:
            state = "warm"
        doc["cache"]["state"] = state
        if last_prune is not None:
            doc["last_prune"] = dict(last_prune)
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
        led = _ledger
    from .. import build

    # builds made before the process had PyTorch (`build.PENDING_LEDGER`);
    # `pop` is atomic, so concurrent callers replay each call once
    while build.PENDING_LEDGER and "torch" in sys.modules:
        try:
            method, args, kwargs = build.PENDING_LEDGER.pop(0)
        except IndexError:
            break
        getattr(led, method)(*args, **kwargs)
    return led


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
