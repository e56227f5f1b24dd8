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
"""

from .stages import (  # noqa: F401
    NULL_OBSERVER,
    PLANNER_PATHS,
    STAGES,
    NullObserver,
    PipelineMetrics,
    create_pipeline_metrics,
    default_pipeline,
)
from .trace import (  # noqa: F401
    annotation,
    named_scope,
    profiling_active,
    start_profiling,
    stop_profiling,
)
from .compile_ledger import (  # noqa: F401
    CompileLedger,
    StartupTimeline,
    ledger,
    timeline,
)
from .flight_recorder import FlightRecorder, recorder  # noqa: F401
from .device_ledger import DeviceLedger  # noqa: F401
from .runtime import runtime_info  # noqa: F401
from .spans import (  # noqa: F401
    MILESTONES,
    Tracer,
    current_trace_id,
    record_slot_milestone,
    tracer,
)
