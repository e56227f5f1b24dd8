"""The traced run's profiled slice: `torch.profiler` over the traced
window, from before its first call to after its last call's return, on
every thread of the process, with the device's activity kept in memory
(no trace file is written), reduced to the few sums the per-layer
metrics read.

- Jobs: the facade's `bls_verify_batch/<n>` and
  `bls_verify_individual/<n>` scopes that lie wholly inside the slice,
  one per verdict of the verifier beneath it. `span` runs from the first
  such job's start to the last one's end.
- Operations: PyTorch operator events (`aten::*`) that start inside
  `span` and lie inside no other operator of their thread.
- Device: every activity on the card (kernels, copies, fills). `busy_s`
  is the union of their intervals over the slice; kernel time inside
  `span` per job; the launches of the tower kernels with their grids.
"""

from __future__ import annotations

import json
from collections import defaultdict

JOB_PREFIXES = ("bls_verify_batch/", "bls_verify_individual/")
# the slice's two ends, as events on the profiler's own clock
MARK_START, MARK_STOP = "bench/slice_start", "bench/slice_stop"


def start():
    """A started profiler over CPU and CUDA activity on all threads."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch._C._profiler import _ExperimentalConfig

    config = _ExperimentalConfig(profile_all_threads=True, expose_kineto_event_metadata=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=config, acc_events=False)
    torch.cuda.synchronize()
    prof.start()
    with torch.profiler.record_function(MARK_START):
        pass
    return prof


def stop(prof) -> list:
    """Stop the profiler; its raw events, unparsed."""
    import torch

    with torch.profiler.record_function(MARK_STOP):
        pass
    prof.stop()
    return list(prof.profiler.kineto_results.events())


def _grid(ev) -> tuple | None:
    try:
        meta = json.loads("{" + ev.metadata_json() + "}")
    except (AttributeError, ValueError, TypeError):
        return None
    grid, block = meta.get("grid"), meta.get("block")
    if not grid or not block:
        return None
    return tuple(grid), tuple(block)


def _union(intervals) -> tuple[float, list]:
    """(covered seconds, gaps as (start, end)) of (start, end) intervals."""
    covered, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


class Slice:
    """The reduction of one profiled slice; times in ns unless named _s."""

    def __init__(self, events):
        import torch

        cuda = torch._C._autograd.DeviceType.CUDA
        marks = {ev.name(): ev.start_ns() for ev in events
                 if ev.name() in (MARK_START, MARK_STOP)}
        self.t0, self.t1 = marks[MARK_START], marks[MARK_STOP]
        self.window_s = (self.t1 - self.t0) / 1e9
        device, ops_by_thread, scopes = [], defaultdict(list), []
        for ev in events:
            start, dur = ev.start_ns(), ev.duration_ns()
            name = ev.name()
            if ev.device_type() == cuda:
                # the device-side image of a host scope is no activity
                if not (ev.is_user_annotation() or name.startswith(("bls", "bench"))):
                    device.append((name, start, dur, ev))
                continue
            if name.startswith("aten::"):
                ops_by_thread[ev.start_thread_id()].append((start, dur))
            elif name.startswith("bls"):
                scopes.append((name, start, start + dur, ev.start_thread_id()))
        self.jobs = sorted((s, e, n) for n, s, e, _ in scopes
                           if n.startswith(JOB_PREFIXES) and s >= self.t0 and e <= self.t1)
        self.scopes = scopes
        self.span = (self.jobs[0][0], self.jobs[-1][1]) if self.jobs else None
        intervals = [(max(s, self.t0), min(s + d, self.t1)) for _, s, d, _ in device
                     if s + d > self.t0 and s < self.t1]
        busy, gaps = _union(intervals)
        self.busy_s = busy / 1e9
        self.gaps = gaps
        if intervals:  # the idle stretches at the slice's two ends
            first = min(s for s, _ in intervals)
            last = max(e for _, e in intervals)
            self.gaps = [(self.t0, first)] + gaps + [(last, self.t1)]
        else:
            self.gaps = [(self.t0, self.t1)]
        self.kernels = [(n, s, d, ev) for n, s, d, ev in device
                        if not n.startswith(("Memcpy", "Memset"))]
        self.device_by_name = defaultdict(int)
        for n, s, d, _ in device:
            if s >= self.t0 and s < self.t1:
                self.device_by_name[n] += d
        self.ops_in_span = 0
        if self.span is not None:
            lo, hi = self.span
            for evs in ops_by_thread.values():
                end = None
                for s, d in sorted(evs, key=lambda x: (x[0], -x[1])):
                    if end is not None and s < end:
                        continue  # inside an operator of its own thread
                    end = s + d
                    if lo <= s < hi:
                        self.ops_in_span += 1

    def kernels_in_span(self):
        if self.span is None:
            return []
        lo, hi = self.span
        return [k for k in self.kernels if lo <= k[1] < hi]

    def launches(self, fragment: str):
        """(ns, grid and block or None) of each launch of a kernel whose name
        holds `fragment`, anywhere in the slice."""
        return [(d, _grid(ev)) for n, s, d, ev in self.kernels
                if fragment in n and self.t0 <= s < self.t1]

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the
        card's idle time by what the host was doing: each gap between device
        activities is charged to the innermost `bls*` scope open at its
        midpoint (a sweep over the scopes in start order)."""
        ops = sorted(self.device_by_name.items(), key=lambda x: -x[1])[:10]
        scopes = sorted((b, f, n) for n, b, f, _ in self.scopes)
        idle: dict = defaultdict(int)
        active: list = []
        nxt = 0
        for s, e in sorted(self.gaps):
            mid = (s + e) / 2
            while nxt < len(scopes) and scopes[nxt][0] <= mid:
                active.append(scopes[nxt])
                nxt += 1
            active = [a for a in active if a[1] > mid]
            name = max(active)[2] if active else "no verifier scope open"
            idle[name] += e - s
        gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, d / 1e9] for n, d in ops],
                "idle_gaps": [[n, d / 1e9] for n, d in gaps]}

    def summary(self) -> str:
        """One line for the run's log: what the slice holds."""
        grids = sum(1 for f in ("miller_proj", "final_exp_warp", "pairing_warp")
                    for _, gb in self.launches(f) if gb is not None)
        names = sorted(self.device_by_name.items(), key=lambda x: -x[1])[:4]
        return (f"slice {self.window_s:.3f} s, {len(self.jobs)} whole jobs, "
                f"{self.ops_in_span} operators in them, busy {self.busy_s:.3f} s, "
                f"{len(self.kernels)} kernels ({grids} tower launches with grids), "
                f"top {[(n[:40], d / 1e9) for n, d in names]}")
