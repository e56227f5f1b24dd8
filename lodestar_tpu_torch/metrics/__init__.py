"""Metric primitives and the registry that renders them (the JAX package's
`metrics/registry.py`; its beacon metric sets and HTTP server are not
ported)."""

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    GaugeFunc,
    Histogram,
    MetricsRegistry,
    Summary,
)
