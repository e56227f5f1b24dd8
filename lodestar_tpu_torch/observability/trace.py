"""Profiler integration: named scopes and the profiler switch (the JAX
package's `observability/trace.py` on `torch.profiler`).

Three scope kinds, all host-side, so code can annotate unconditionally:

- `annotation(label)`: `torch.profiler.record_function(label)`, a span on
  the profiler's timeline around host work (one facade job, marshal,
  resolve).
- `named_scope(label)`: the same span plus an NVTX range when CUDA is
  available, around a device stage of a verdict (the MSMs, the Miller
  loop, the final exponentiation), so that the kernels launched inside
  it are attributable in a `torch.profiler` trace or an NVTX timeline.
  The JAX package tags HLO ops with `jax.named_scope` at the same places.
- `device_stage(label)`: a `named_scope` whose host seconds also go to the
  observer bound on the thread by `observing(observer)` (a verifier binds
  its own around each verdict; a mesh worker binds a recorder whose sums
  travel back with its reply), as stage `label` of
  `lodestar_bls_pipeline_stage_seconds`: the seven `bls/<stage>` scopes
  of the verdicts (`bls/g2_decompress`, `bls/scalar_mul`,
  `bls/msm_planes`, `bls/miller_loop`, `bls/product_tree`,
  `bls/final_exp_batch`, `bls/plane_subgroup`). One pair of clock reads
  per scope, no synchronisation: the seconds are the host's, to enqueue the
  stage. With nothing bound it is a `named_scope`.

None synchronises or reads a tensor, so all stay legal inside a CUDA
graph capture, and outside a running profiler `record_function` costs
about a microsecond; the scopes sit around stages, never around single
operations.

Which intervals get a scope, and which only a stage counter. A profile's
idle gaps on the card are charged to the latest-started `bls*` scope open
on any thread, so a scope names host WORK on one thread:

- waits are counted, never scoped: a call's wait in its lane
  (`lane_wait`) and a device call's wait for the supervisor's dispatch
  thread (`dispatch_wait`). A waiting thread's scope would take the gap
  from the thread that does the work. The resolver's wait for a verdict
  (`bls/device_wait`) is scoped: the card computes through it, so it
  holds no gap to take;
- host work on one thread gets a `bls/` scope and a stage of the same
  work: the verifier's host stages (`bls/marshal`, `bls/hash_to_curve`,
  `bls/rand`, `bls/dispatch`, `bls/device_wait`; stage `bisect` keeps the
  probe kernel's `bls/bisect`) and the supervisor's negative audit on the
  host tier (`bls/audit`, stage `audit`);
- the device stages are `device_stage` scopes, counter and scope under
  one name;
- no scope starts with `bls_verify_batch/` or `bls_verify_individual/`
  but the facade's job scopes: a reader of the profile counts those as
  verdicts.

`start_profiling(trace_dir)` / `stop_profiling()` are the one
process-wide switch over `torch.profiler.profile` (CPU activity, and CUDA
when available): one trace at a time, and `stop_profiling` exports it as
a Chrome trace into the directory. The JAX package also starts a trace
from LODESTAR_TPU_PROFILE; the port starts one only when asked.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time

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


# the observer that `device_stage` scopes report to on this thread
_stage_observer: "contextvars.ContextVar" = contextvars.ContextVar(
    "lodestar_tpu_torch_stage_observer", default=None)


@contextlib.contextmanager
def observing(observer):
    """Bind `observer` (duck-typed: `observe_stage(name, seconds)`) for the
    `device_stage` scopes this thread opens inside the block."""
    token = _stage_observer.set(observer)
    try:
        yield observer
    finally:
        _stage_observer.reset(token)


def observe_stage(label: str, seconds: float) -> None:
    """Observe `seconds` of stage `label` into the bound observer, if any."""
    observer = _stage_observer.get()
    if observer is not None:
        observer.observe_stage(label, seconds)


@contextlib.contextmanager
def device_stage(label: str):
    """A device stage's `named_scope`, whose host seconds go to the bound
    observer as stage `label`."""
    observer = _stage_observer.get()
    if observer is None:
        with named_scope(label):
            yield
        return
    t0 = time.monotonic()
    try:
        with named_scope(label):
            yield
    finally:
        observer.observe_stage(label, time.monotonic() - t0)


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
