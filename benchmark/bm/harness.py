"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Set-up makes the cell's inputs from the seed (`traffic.Mix`), builds the
serving stack as a node does (`build_bls_stack(device="cuda", mesh=None)`),
populates its epoch table with the cell's keys, and warms every path the
traffic takes by running the traffic itself for the traffic file's
`warmup` units. The window then drives the stack's `verifier` with the
traffic's closed loop for `--seconds`, and the run reports its end-to-end
metrics. With `--trace 1` the window is profiled from the main thread
(`trace.py`), its callers take units for `trace_slice.length_s` seconds
and the profiler stops once every call has returned; the run reports its
per-layer metrics. Once every call has returned, the stack is closed and
the reference (`bls_ref.py`) works out again the verdict of every call
that the window made.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import multiprocessing
import os
import random
import statistics
import sys
import threading
import time

from . import bls_ref, compare, paths, traffic
from .trace import Slice
from . import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "lodestar_tpu")
DRAIN_S = 60.0  # how long after the window a call may still return
TRACED_DRAIN_S = 120.0  # the same under the profiler, which slows dispatch 2-6x
# the supervisor's fallback reasons under which the host tier answered in
# the card's place (a "negative_audit" only confirms a device False)
HOST_SERVED = ("breaker_open", "deadline", "exception")


class CellError(RuntimeError):
    """A cell, configuration, traffic or metric that cannot be found or run."""


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CellError(f"missing file {path}") from e


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic and the
    metrics it reports, found by name."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench if bench is not None else load_json(paths.benchmark_json())
        self.bench = bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json(paths.config_file(self.workload["config"]))
        self.traffic = load_json(paths.traffic_file(self.workload["traffic"]))
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric_name: str):
        """The `read(ctx)` of the metric's own reader file."""
        path = paths.metric_file(metric_name)
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric_name.replace(".", "_"), path)
        if spec is None:
            raise CellError(f"missing reader {path}")
        module = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(module)
        except FileNotFoundError as e:
            raise CellError(f"missing reader {path}") from e
        return module.read


# -- the stack's counters ------------------------------------------------------


def _prom_value(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{}"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def counters(stack) -> dict:
    """What the window's per-layer metrics and `failed` read, now."""
    pipe = stack.pipeline
    sup = pipe.supervisor_snapshot()
    text = stack.registry.expose()
    return {
        "stages": pipe.stage_snapshot(),
        "planner": dict(pipe.planner_snapshot().get("decisions", {})),
        "fallbacks": dict(sup.get("fallbacks", {})),
        "verdict_mismatches": sup.get("verdict_mismatches", 0),
        "sets_per_job": {"sum": _prom_value(text, "lodestar_bls_verifier_sets_per_job_sum"),
                         "count": _prom_value(text, "lodestar_bls_verifier_sets_per_job_count")},
    }


def delta(after: dict, before: dict) -> dict:
    stages = {}
    for stage, v in after["stages"].items():
        b = before["stages"].get(stage, {"sum_s": 0.0, "count": 0})
        stages[stage] = {"sum_s": v["sum_s"] - b["sum_s"], "count": v["count"] - b["count"]}
    return {
        "stages": stages,
        "planner": {k: v - before["planner"].get(k, 0) for k, v in after["planner"].items()},
        "fallbacks": {k: v - before["fallbacks"].get(k, 0) for k, v in after["fallbacks"].items()},
        "verdict_mismatches": after["verdict_mismatches"] - before["verdict_mismatches"],
        "sets_per_job": {k: after["sets_per_job"][k] - before["sets_per_job"][k]
                         for k in ("sum", "count")},
    }


def settings(stack) -> dict:
    """The stack's settings as it built them by default."""
    lanes, sup, dev = stack.verifier, stack.supervisor, stack.device
    return {
        "lane_workers": getattr(lanes, "workers", None),
        "max_coalesce": getattr(lanes, "max_coalesce", None),
        "flush_sets": getattr(lanes, "max_sigs", None),
        "flush_wait_s": getattr(lanes, "max_wait", None),
        "pending_cap": getattr(lanes, "pending_cap", None),
        "lane_caps": getattr(lanes, "lane_caps", None),
        "job_sets": getattr(dev, "max_sets_per_job", None),
        "deadline_s": getattr(sup, "deadline_s", None),
        "audit_negative": getattr(sup, "audit_negative", None),
        "breaker_threshold": getattr(sup, "failure_threshold", None),
    }


# -- the closed loop ---------------------------------------------------------------


class Loop:
    """The traffic's closed loop: each caller takes the next unit, makes its
    calls in order, each when the previous one returned, and takes another
    until `stop()` says so. Every call is recorded as (unit, call index,
    item, invalid, submitted, returned, verdict or None, error name, sets)."""

    def __init__(self, mix, wrapped, verifier, callers: int):
        self.mix, self.wrapped, self.verifier = mix, wrapped, verifier
        self.callers = callers
        self.records: list = []
        self.pending: dict = {}  # guarded-by: _lock; thread id -> the call in flight
        self._lock = threading.Lock()
        self._next = 0

    def run(self, first: int, stop, force_invalid: int | None = None) -> None:
        """Start the callers at unit `first`; each stops when `stop(unit)` is
        true before it takes a unit."""
        self._next = first
        specs = self.mix.calls

        def caller():
            while True:
                with self._lock:
                    k = self._next
                    if stop(k):
                        return
                    self._next += 1
                idx, bad, calls = self.mix.unit(k, force_invalid=(k == force_invalid))
                for ci, spec in enumerate(specs):
                    sets = self.wrapped[bad][idx] if spec["sets"] == "all" else \
                        self.wrapped[bad][idx][: len(calls[ci])]
                    t0 = time.perf_counter()
                    with self._lock:
                        self.pending[threading.get_ident()] = (k, ci, idx, bad, t0, len(sets))
                    verdict, err = None, None
                    try:
                        verdict = bool(self.verifier.verify_signature_sets(
                            sets, batchable=spec["batchable"], lane=spec["lane"]))
                    except Exception as e:  # a shed or a timeout: the call failed
                        err = type(e).__name__
                    t1 = time.perf_counter()
                    with self._lock:
                        self.pending.pop(threading.get_ident(), None)
                        self.records.append((k, ci, idx, bad, t0, t1, verdict, err, len(sets)))

        threads = [threading.Thread(target=caller, name=f"bench-caller-{i}", daemon=True)
                   for i in range(self.callers)]
        for t in threads:
            t.start()
        self.threads = threads

    def join(self, deadline: float) -> bool:
        """Wait for the callers until `deadline`; a call still in flight then
        is recorded as one that never returned. True when all are back."""
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        with self._lock:
            now = time.perf_counter()
            for k, ci, idx, bad, t0, n in self.pending.values():
                self.records.append((k, ci, idx, bad, t0, now, None, "no verdict", n))
            self.pending.clear()
        return not any(t.is_alive() for t in self.threads)


# -- one run -----------------------------------------------------------------------


def end_to_end(cell: Cell, window: list, t0: float, seconds: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics from its window's calls: `setup_s`,
    and those of `E2E` that the cell reports."""
    out = {"setup_s": setup_s}
    for m in cell.end_to_end:
        if m["name"] != "setup_s":
            out[m["name"]] = E2E[m["name"]](cell, window, t0, seconds)
    return out


def att_sets_per_s(cell, window, t0, seconds):
    """Sets verified per second over all the window's work: the sets of
    every call made inside the window that returned a verdict, over the
    seconds from the window's start to the last of those calls' return."""
    return sum(r[8] for r in window if r[6] is not None) / (max(r[5] for r in window) - t0)


def block_s(cell, window, t0, seconds):
    """Seconds per unit: from the window's start to the last verdict of the
    last unit started inside it, over the units started inside it."""
    units = {r[0] for r in window}
    return (max(r[5] for r in window) - t0) / len(units)


def call_p95_s(cell, window, t0, seconds):
    """95th percentile of a call's seconds from its submission to its
    verdict, over every call made inside the window (those that return
    after the close included)."""
    return statistics.quantiles([r[5] - r[4] for r in window], n=20, method="inclusive")[18]


E2E = {"att_sets_per_s": att_sets_per_s, "att_p95_s": call_p95_s, "block_s": block_s}


def host_served(win: dict) -> int:
    """Calls and sets that the host tier answered in the card's place over
    the window: supervisor fallbacks for an open breaker, a blown deadline
    or a raised dispatch, and device verdicts its audit overturned. The
    configurations state that every verdict comes from the card."""
    return sum(v for k, v in win["fallbacks"].items() if k in HOST_SERVED) + \
        win["verdict_mismatches"]


def latencies(window: list) -> str:
    """The window's call latencies, for the run's log."""
    lat = sorted(r[5] - r[4] for r in window)
    if len(lat) < 2:
        return "latency: too few calls"
    q = statistics.quantiles(lat, n=20, method="inclusive")
    return f"latency p50 {q[9]:.3f} s, p95 {q[18]:.3f} s, max {lat[-1]:.3f} s"


class Run:
    """One run of a cell. `stack_factory` puts a stand-in in place of the
    card's stack (the checks of the check itself), and the run then skips
    everything that reads the card."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
                 stack_factory=None, log=None, ref_workers: int | None = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.ref_workers = ref_workers or min(8, os.cpu_count() or 1)
        self.t_process = t_process
        self.stack_factory = stack_factory
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))

    def _build_stack(self):
        if self.stack_factory is not None:
            return self.stack_factory()
        from lodestar_tpu_torch.node.bls_stack import build_bls_stack

        return build_bls_stack(device="cuda", mesh=None)

    def _wrap(self, mix):
        """The pool in the program's set type, valid and invalid variants."""
        from lodestar_tpu_torch.bls.api import PublicKey, SignatureSet

        def wrap(items):
            return [[SignatureSet(PublicKey(pk), root, sig) for pk, root, sig in item]
                    for item in items]

        return {False: wrap(mix.items), True: wrap(mix.bad_items)}

    def execute(self):
        """(result, the check's lines) of one run."""
        cell, tr = self.cell, self.cell.traffic
        mix = traffic.Mix(cell.config, tr, self.seed)
        wrapped = self._wrap(mix)
        self.log(f"inputs: {len(mix.items)} items, {sum(len(i) for i in mix.items)} sets, "
                 f"invalid offset {mix.offset} of every {mix.every}, "
                 f"{time.perf_counter() - self.t_process:.3f} s after start")
        stack = self._build_stack()
        closed = []
        try:
            return self._with_stack(stack, mix, wrapped, closed)
        finally:
            if not closed:
                stack.close()

    def _with_stack(self, stack, mix, wrapped, closed: list):
        cell, tr = self.cell, self.cell.traffic
        print(json.dumps({"settings": settings(stack)}), flush=True)
        stack.populate_epoch_async(cell.config["slot"] // cell.config["preset"]["SLOTS_PER_EPOCH"],
                                   mix.table_keys)
        if not stack.wait_populated(300):
            raise CellError("the epoch table was not populated within 300 s")
        last = getattr(stack, "last_populate", None) or {}
        if "error" in last:
            raise CellError(f"epoch-table population failed: {last['error']}")
        loop = Loop(mix, wrapped, stack.verifier, int(tr["callers"]))
        warm = int(tr["warmup"]["units"])
        force = warm // 2 if tr["warmup"].get("with_invalid") else None
        loop.run(0, lambda k: k >= warm, force_invalid=force)
        if not loop.join(time.perf_counter() + 600):
            raise CellError("the warm-up did not finish within 600 s")
        warm_records = loop.records
        self.log(f"warm-up: {len(warm_records)} calls, "
                 f"{time.perf_counter() - self.t_process:.3f} s after start")

        prof, length, drain = None, self.seconds, DRAIN_S
        if self.trace:
            # the profiler's first start initialises it; the slice's own start
            # comes while nothing is in flight on the card or the host, and
            # its stop too: the stop holds the process for a minute or more,
            # and a device job held across it would outlive the supervisor's
            # deadline and be answered by the host tier
            tracing.stop(tracing.start())
            prof = tracing.start()
            length = min(self.seconds, float(tr["trace_slice"]["length_s"]))
            drain = TRACED_DRAIN_S
        before = counters(stack)
        loop.records = []
        t0 = time.perf_counter()
        t_end = t0 + length
        loop.run(warm, lambda k: time.perf_counter() >= t_end)
        drained = loop.join(t_end + drain)  # a call may return up to `drain` after the close
        t_closed = time.perf_counter()
        events = tracing.stop(prof) if self.trace else None
        after = counters(stack)
        window = sorted(loop.records, key=lambda r: (r[0], r[1]))
        self.log(f"window: {len(window)} calls, closed {t_closed - t_end:.3f} s after "
                 f"its {length:g} s, every caller back: {drained}, {latencies(window)}")
        memory_peak = self._memory_peak()
        win = delta(after, before)
        ctx = Context(cell, win, window)
        if self.trace:
            ctx.slice = Slice(events)
            del events
            self.log(ctx.slice.summary())
        stack.close()
        closed.append(True)
        del stack
        gc.collect()
        self._free()

        # the check: every call of the window against the reference
        t_ref = time.perf_counter()
        check = reference_check(mix, window, self.seed, self.ref_workers)
        self.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
        check["host_served"] = {"value": host_served(win), "limit": 0}
        correct = all(v["value"] <= v["limit"] for v in check.values())

        failed = sum(1 for r in window if r[6] is None) + host_served(win)
        result = {"correct": correct, "attempted": len(window), "failed": failed}
        metrics = {}
        if self.trace:
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = end_to_end(cell, window, t0, self.seconds, t0 - self.t_process)
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = self._device(memory_peak, ctx.slice if self.trace else None)
        if self.trace:
            result["breakdown"] = ctx.slice.breakdown()
        result["check"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in check.items()}
        lines = [f"{k}: {v['value']} (limit {v['limit']})" for k, v in check.items()]
        return result, lines

    # -- device facts ----------------------------------------------------------

    def _memory_peak(self) -> int:
        if self.stack_factory is not None:
            return 0
        import torch

        return int(max(torch.cuda.max_memory_allocated(i) for i in range(self.cell.chips)))

    def _free(self):
        if self.stack_factory is None:
            import torch

            torch.cuda.empty_cache()

    def _device(self, memory_peak: int, sl) -> dict:
        if self.stack_factory is not None:
            dev = {"platform": "cpu", "kind": "test", "count": self.cell.chips,
                   "memory_peak_bytes": memory_peak}
        else:
            import torch

            dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": self.cell.chips, "memory_peak_bytes": memory_peak}
        if sl is not None:
            dev["busy_s"] = sl.busy_s
            dev["window_s"] = sl.window_s
        return dev


def reference_check(mix, window, seed: int, workers: int) -> dict:
    """`compare.check` with the reference spread over `workers` processes,
    each stopped and waited for before this returns."""
    rng = random.Random(f"reference:{seed}")
    if workers <= 1:
        return compare.check(mix, window, bls_ref.Reference(rng), seed)
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        return compare.check(mix, window, bls_ref.Reference(rng, pool), seed)
    finally:
        pool.close()
        pool.join()


class Context:
    """What a per-layer reader reads: `window` (the stack's counters over
    the window, `delta`), `calls` (the window's call records), `slice` (the
    profiled slice, a `trace.Slice`) and the `cell`."""

    def __init__(self, cell, window, calls):
        self.cell, self.window, self.calls = cell, window, calls
        self.slice = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))

