"""Metric primitives and the registry that renders them (the JAX package's
`metrics/registry.py`), the batching facades' families (`bls.py`, the
`bls_*` part of its `metrics/beacon.py`), the node's whole beacon set
(`beacon.py`), GC pauses (`gc_stats.py`), the per-validator monitor
(`validator_monitor.py`) and the HTTP server (`server.py`)."""

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    GaugeFunc,
    Histogram,
    MetricsRegistry,
    Summary,
)
