"""Profiler integration: named scopes and the profiler switch (the JAX
package's `observability/trace.py` on `torch.profiler`).

Two scope kinds, both host-side, so code can annotate unconditionally:

- `annotation(label)`: `torch.profiler.record_function(label)`, a span on
  the profiler's timeline around host work (one facade job, marshal,
  resolve).
- `named_scope(label)`: the same span plus an NVTX range when CUDA is
  available, around a device stage of a verdict (the MSMs, the Miller
  loop, the final exponentiation), so that the kernels launched inside
  it are attributable in a `torch.profiler` trace or an NVTX timeline.
  The JAX package tags HLO ops with `jax.named_scope` at the same places.

Neither synchronises nor reads a tensor, so both stay legal inside a CUDA
graph capture, and outside a running profiler `record_function` costs
about a microsecond; the scopes sit around stages, never around single
operations.

`start_profiling(trace_dir)` / `stop_profiling()` are the one
process-wide switch over `torch.profiler.profile` (CPU activity, and CUDA
when available): one trace at a time, and `stop_profiling` exports it as
a Chrome trace into the directory. The JAX package also starts a trace
from LODESTAR_TPU_PROFILE; the port starts one only when asked.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

_lock = threading.Lock()
_active_dir: str | None = None
_active_profile = None  # guarded-by: _lock
_exports = 0  # guarded-by: _lock
_nvtx: bool | None = None


def annotation(label: str):
    """Host-side profiler span."""
    return torch.profiler.record_function(label)


def _nvtx_enabled() -> bool:
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    return _nvtx


@contextlib.contextmanager
def named_scope(label: str):
    """A device stage's span: `record_function`, plus an NVTX range when
    CUDA is available."""
    nvtx = _nvtx_enabled()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def default_trace_dir() -> str:
    """`build/lodestar_tpu_torch/trace` in the checkout (ignored by git)."""
    from ..build import BUILD_DIR

    return os.path.join(BUILD_DIR, "trace")


def profiling_active() -> bool:
    return _active_dir is not None


def start_profiling(trace_dir: str | None = None) -> str | None:
    """Start a `torch.profiler` trace that `stop_profiling` writes into
    `trace_dir` (default `default_trace_dir()`); returns the directory,
    or None if a trace is already running. A profiler that fails to start
    raises."""
    global _active_dir, _active_profile
    trace_dir = trace_dir or default_trace_dir()
    with _lock:
        if _active_dir is not None:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _active_profile, _active_dir = prof, trace_dir
        return trace_dir


def stop_profiling() -> str | None:
    """Stop the running trace and export it as `trace-<pid>-<n>.json` into
    its directory; returns the directory, or None if no trace was running.
    The switch resets even when the profiler fails to stop or export (the
    error is raised)."""
    global _active_dir, _active_profile, _exports
    with _lock:
        if _active_dir is None:
            return None
        prof, stopped = _active_profile, _active_dir
        _active_profile = _active_dir = None
        _exports += 1
        prof.stop()
        os.makedirs(stopped, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(stopped, f"trace-{os.getpid()}-{_exports}.json"))
        return stopped
