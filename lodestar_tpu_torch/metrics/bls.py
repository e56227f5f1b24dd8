"""The batching facades' metric families (the `bls_*` part of the JAX
package's `metrics/beacon.py`, same names, labels and buckets).

`create_bls_metrics(registry)` registers them on the registry the caller
passes, so `/metrics` serves them beside `PipelineMetrics`; the facades
(`ThreadBufferedVerifier`, `BufferedVerifier`, `BlsLaneDispatcher`) write
through it as their `prom=`. A family already on the registry is reused,
so building the stack twice over one registry registers nothing twice.
"""

from __future__ import annotations

from .registry import MetricsRegistry

# (attribute, kind, name, help) as `metrics/beacon.py` registers them
FAMILIES = (
    ("bls_batches_total", "counter", "lodestar_bls_verifier_batches_total",
     "batched verification dispatches"),
    ("bls_sets_total", "counter", "lodestar_bls_verifier_sets_total",
     "signature sets verified"),
    ("bls_batch_fallbacks_total", "counter", "lodestar_bls_verifier_batch_fallbacks_total",
     "batches that failed and fell back to per-set verdicts"),
    ("bls_buffer_depth", "gauge", "lodestar_bls_verifier_buffer_sigs",
     "signature sets waiting in the batch buffer"),
    ("bls_buffer_wait_seconds", "histogram", "lodestar_bls_verifier_buffer_wait_seconds",
     "time a set waited in the buffer before dispatch"),
    ("bls_job_sets", "histogram", "lodestar_bls_verifier_sets_per_job",
     "signature sets per device dispatch"),
    ("bls_main_thread_sets_total", "counter", "lodestar_bls_verifier_main_thread_sets_total",
     "sets verified synchronously (non-batchable path)"),
)


class BlsMetrics:
    """The seven families as attributes, plus the `registry` they live on."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        existing = {m.name: m for m in registry._metrics}
        for attr, kind, name, help_ in FAMILIES:
            metric = existing.get(registry.prefix + name)
            if metric is None:
                metric = getattr(registry, kind)(name, help_)
            setattr(self, attr, metric)


def create_bls_metrics(registry: MetricsRegistry | None = None) -> BlsMetrics:
    return BlsMetrics(registry if registry is not None else MetricsRegistry())


LIFECYCLE_TRACES = ("lodestar_lifecycle_traces_total",
                    "completed lifecycle traces by root span kind")


def lifecycle_traces_counter(registry: MetricsRegistry):
    """`lodestar_lifecycle_traces_total{kind}` on `registry` (the family
    `metrics/beacon.py` registers for `observability/spans.py`), reused
    when the registry already has it."""
    name, help_ = LIFECYCLE_TRACES
    for m in registry._metrics:
        if m.name == registry.prefix + name:
            return m
    return registry.counter(name, help_, label_names=("kind",))
