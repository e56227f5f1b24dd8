"""Pipeline telemetry of the port's verifier stack (the pipeline half of
the JAX package's `observability/`):

- `stages`: `PipelineMetrics` (stage timers, planner, cache, epoch-table,
  bisection, supervisor, lane and ledger families in a
  `metrics.registry` registry, named as the JAX package names them),
  `default_pipeline()`, the observer of the verifier, the facade and the
  epoch table when none is passed, and `NullObserver`.
- `trace`: `record_function` / NVTX scopes, the device-stage scopes that
  also time their host seconds into the observer a verifier binds
  (`device_stage`, `observing`), the rules for what gets a scope, and the
  `torch.profiler` start/stop switch.

Stage labels of `lodestar_bls_pipeline_stage_seconds` beyond the JAX
package's taxonomy (`stages.STAGES`), all recorded through
`observe_stage`:

- `lane_wait`: a call's seconds in its lane before its batch left
  (`chain/dispatcher.py`; counted, not scoped);
- `dispatch_wait`: a device call's seconds waiting for the supervisor's
  one dispatch thread, 0 on the inline path (`chain/supervisor.py`;
  counted, not scoped);
- `audit`: the host tier's seconds of one negative audit, under the
  profiler scope `bls/audit`;
- `bls/g2_decompress`, `bls/scalar_mul`, `bls/msm_planes`,
  `bls/miller_loop`, `bls/product_tree`, `bls/final_exp_batch`,
  `bls/plane_subgroup`: the host seconds to enqueue each device stage of a
  verdict, named as its scope.

The verifier's host stages (`marshal`, `hash_to_curve`, `rand`,
`dispatch`, `device_wait`) also open the scopes `bls/<stage>`; `bisect`
keeps the probe kernel's `bls/bisect`.
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
    "trace": ("annotation", "device_stage", "named_scope", "observe_stage", "observing",
              "profiling_active", "start_profiling", "stop_profiling"),
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
