"""GC pause metrics — the reference's `gc-stats`/`prometheus-gc-stats`
equivalent (SURVEY.md §2.3 native deps table; beacon-node package.json).

CPython exposes collection hooks via `gc.callbacks`; we time each
collection and export pause histograms + collected-object counters per
generation. `install_gc_metrics(registry)` is idempotent.

The port's copy of the JAX package's `metrics/gc_stats.py`.
"""

from __future__ import annotations

import gc
import time


class GcMetrics:
    def __init__(self, registry):
        self.pause_seconds = registry.histogram(
            "python_gc_pause_seconds", "stop-the-world GC pause duration",
            label_names=("generation",),
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
        )
        self.collections_total = registry.counter(
            "python_gc_collections_total", "GC runs per generation",
            label_names=("generation",),
        )
        self.collected_total = registry.counter(
            "python_gc_collected_objects_total", "objects collected",
            label_names=("generation",),
        )
        self.uncollectable_total = registry.counter(
            "python_gc_uncollectable_total", "uncollectable objects found",
        )
        self._t0 = 0.0

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        gen = str(info.get("generation", "?"))
        self.pause_seconds.observe(time.perf_counter() - self._t0, generation=gen)
        self.collections_total.inc(generation=gen)
        self.collected_total.inc(info.get("collected", 0), generation=gen)
        if info.get("uncollectable"):
            self.uncollectable_total.inc(info["uncollectable"])


_installed: GcMetrics | None = None


def install_gc_metrics(registry) -> GcMetrics:
    """Install (or rebind) the process-global GC callback.

    The gc hook is registered once; a new registry (e.g. an in-process
    node restart) REPLACES the metric family bundle so the live node's
    /metrics keeps receiving observations instead of a dead registry.
    """
    global _installed
    if _installed is None:
        _installed = GcMetrics(registry)
        gc.callbacks.append(_installed._cb)
    elif _installed.pause_seconds not in getattr(registry, "_metrics", []):
        fresh = GcMetrics(registry)
        fresh._t0 = _installed._t0
        # swap the bundle the registered callback dispatches into
        _installed.__dict__.update(fresh.__dict__)
    return _installed
