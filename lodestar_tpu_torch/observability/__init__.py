"""Pipeline telemetry of the port's verifier stack (the pipeline half of
the JAX package's `observability/`):

- `stages`: `PipelineMetrics` (stage timers, planner, cache, epoch-table,
  bisection, supervisor, lane and ledger families in a
  `metrics.registry` registry, named as the JAX package names them),
  `default_pipeline()`, the observer of the verifier, the facade and the
  epoch table when none is passed, and `NullObserver`.
- `trace`: `record_function` / NVTX scopes and the `torch.profiler`
  start/stop switch.
- `stage_profile`: per-stage device time of the grouped verdict with CUDA
  events, into the same stage histogram.
- `compile_ledger`: library builds and first launches as events, the
  ahead-of-time store's outcomes and preload (`ops/aot_store.py`), and
  the startup timeline.
- `flight_recorder`: the bounded ring of recent events.
- `device_ledger`: busy/idle/overlap device-seconds by lane × kernel ×
  chip and the CUDA memory sampler.
- `runtime`: the runtime identity of the build-info gauge.
- `spans`: node-wide lifecycle tracing: trace-id / parent-id spans with
  context-variable propagation, the ring served at `/debug/traces`, and
  slot-milestone delays.

The names below load their module at first use (PEP 562), so a process
that only records a library build or a span (a validator, a light
client) does not import PyTorch with `stages` and `trace`.
"""

import importlib

_EXPORTS = {
    "stages": ("NULL_OBSERVER", "PLANNER_PATHS", "STAGES", "NullObserver", "PipelineMetrics",
               "create_pipeline_metrics", "default_pipeline"),
    "trace": ("annotation", "named_scope", "profiling_active", "start_profiling",
              "stop_profiling"),
    "compile_ledger": ("CompileLedger", "StartupTimeline", "ledger", "timeline"),
    "flight_recorder": ("FlightRecorder", "recorder"),
    "device_ledger": ("DeviceLedger",),
    "runtime": ("runtime_info",),
    "spans": ("MILESTONES", "Tracer", "current_trace_id", "record_slot_milestone", "tracer"),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_HOME)


def __getattr__(name: str):
    module = _HOME.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
