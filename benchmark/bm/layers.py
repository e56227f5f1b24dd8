"""The sums the per-layer readers share: window deltas of the stack's own
counters (`ctx.window`) and reductions of the profiled slice
(`ctx.slice`). Each returns None where it finds nothing to read."""

from __future__ import annotations

from . import roofline


def stage_seconds_per_count(ctx, stage: str):
    """Host seconds of one `stage` of the verifier, over the window."""
    d = ctx.window["stages"].get(stage)
    return d["sum_s"] / d["count"] if d and d["count"] > 0 else None


def sets_per_job(ctx):
    """Sets per lane batch: `lodestar_bls_verifier_sets_per_job` Δsum/Δcount."""
    d = ctx.window["sets_per_job"]
    return d["sum"] / d["count"] if d["count"] > 0 else None


def bisect_seconds_per_call(ctx):
    """Host seconds of bisection's probe rounds per per-set call."""
    d = ctx.window["stages"].get("bisect")
    calls = ctx.window["planner"].get("individual", 0)
    return d["sum_s"] / calls if d and d["count"] > 0 and calls > 0 else None


def ops_per_job(ctx):
    """PyTorch operators per verdict inside the slice's whole jobs."""
    sl = ctx.slice
    return sl.ops_in_span / len(sl.jobs) if sl is not None and sl.jobs else None


def device_ms_per_job(ctx):
    """Kernel milliseconds per verdict inside the slice's whole jobs."""
    sl = ctx.slice
    if sl is None or not sl.jobs:
        return None
    return sum(d for _, _, d, _ in sl.kernels_in_span()) / 1e6 / len(sl.jobs)


def idle_share(ctx):
    """% of the slice in which nothing ran on the card."""
    sl = ctx.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)


def kernel_roofline(ctx):
    """Σ bound / Σ device time of the tower kernels' launches, in %."""
    return roofline.share(ctx.slice) if ctx.slice is not None else None

