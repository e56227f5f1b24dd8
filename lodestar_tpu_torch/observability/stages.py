"""Stage timers + planner counters + queue gauges for the BLS pipeline
(the JAX package's `observability/stages.py`).

The stage taxonomy follows the verification dataflow:

host stages (timed inline, monotonic clock):
    marshal        wire bytes -> limb arrays (C tier decompress/subgroup)
    hash_to_curve  H(m) for cache-missed signing roots (C tier)
    rand           random-coefficient bit planes
    dispatch       host -> device submit time (launches are asynchronous;
                   excludes device compute)
    device_wait    resolver block time (the verdict's `bool`)
    bisect         bisection probe dispatches on a failed verdict tree
                   (batched final exps; tag `bls/bisect`)

device stages (attributable two ways: `trace.device_stage` scopes around
each stage of the verdict functions for `torch.profiler` and NVTX, and
`stage_profile.profile_stages` timing each stage with CUDA events into
the SAME histogram):
    g2_decompress, scalar_mul, msm_planes, miller_loop, product_tree,
    final_exp, final_exp_batch (`bls/final_exp_batch`); `miller_pallas`
    is the JAX package's Pallas Miller stage, kept in the taxonomy

labels the port records beyond `STAGES` (`observability/__init__.py`
lists them): `lane_wait` and `dispatch_wait` (the serving stack's two
queues), `audit` (the supervisor's host-tier audit), and each device
scope's host seconds under the scope's own name (`bls/plane_subgroup`,
...), which no label above shares

All families live in a `metrics.registry.MetricsRegistry` (the port's
copy) with the JAX package's names, types, help texts, labels and
buckets, so the dashboards and `dashboards/slo_rules.json` read either.
The one exception is `lodestar_tpu_build_info`, whose first two labels
carry the port's runtime (torch, CUDA). `default_pipeline()` is the
process-wide instance that `TorchBlsVerifier`, `DeviceBlsVerifier` and
`EpochPubkeyTable` record into when no observer is passed; `NullObserver`
records nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..metrics.registry import MetricsRegistry
from . import flight_recorder

# label set of the build-info gauge (one constant-1 series whose labels
# carry the runtime identity — observability/runtime.runtime_info
# produces it); the JAX package's first two are "jax" and "jaxlib"
BUILD_INFO_LABELS = (
    "torch", "cuda", "backend", "device_kind", "device_count",
    "mesh_divisor", "compile_cache",
)

STAGES = (
    "marshal",
    "hash_to_curve",
    "rand",
    "dispatch",
    "device_wait",
    "bisect",
    "g2_decompress",
    "scalar_mul",
    "msm_planes",
    "miller_loop",
    "miller_pallas",
    "product_tree",
    "final_exp",
    "final_exp_batch",
)

# planner decisions (parallel/verifier.verify_signature_sets_submit):
#   root_grouped  whole batch on the root-grouped kernel
#   pk_grouped    whole batch on the pubkey-grouped (dual) kernel
#   split         shared-root part peeled off, remainder routed separately
#                 (the parts also count under their own paths)
#   per_set       flat per-set kernel (nothing grouped)
#   individual    per-set verdict retry path
PLANNER_PATHS = ("root_grouped", "pk_grouped", "split", "per_set", "individual")

_STAGE_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60,
)
_GROUP_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _block_until_ready(x):
    """Wait until the work that produces `x` (a tensor, or a tuple or list
    of them) is done: an event recorded on the current stream of each
    CUDA device among them, and synchronised. A CPU tensor was computed
    eagerly; there is nothing to wait on."""
    todo, devices = [x], set()
    while todo:
        v = todo.pop()
        if isinstance(v, (tuple, list)):
            todo.extend(v)
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            devices.add(v.device)
    for d in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(d))
        event.synchronize()


class _StageTimer:
    """Context manager: observes monotonic elapsed seconds into the stage
    histogram. `bound(x)` registers a value to wait on before the clock
    stops, so asynchronous launches are timed to completion; without it
    nothing synchronises."""

    __slots__ = ("_pipeline", "_stage", "_bound", "t0", "elapsed")

    def __init__(self, pipeline: "PipelineMetrics", stage: str):
        self._pipeline = pipeline
        self._stage = stage
        self._bound = None
        self.elapsed = 0.0

    def bound(self, x):
        self._bound = x
        return x

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self._bound is not None:
            _block_until_ready(self._bound)
        self.elapsed = time.monotonic() - self.t0
        self._pipeline.observe_stage(self._stage, self.elapsed)
        return False


class PipelineMetrics:
    """The telemetry families + recording API for one verifier pipeline."""

    def __init__(self, registry: MetricsRegistry | None = None, faults=None):
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        # the fault plan `supervisor_snapshot` reports (duck-typed: its
        # `snapshot()`, as the JAX package's `testing.faults`); none by
        # default
        self._faults = faults
        self.stage_seconds = r.histogram(
            "lodestar_bls_pipeline_stage_seconds",
            "per-stage latency of the BLS verification pipeline",
            label_names=("stage",),
            buckets=_STAGE_BUCKETS,
        )
        self.planner_decisions = r.counter(
            "lodestar_bls_verifier_planner_decisions_total",
            "batch-planner routing decisions by kernel path",
            label_names=("path",),
        )
        self.planner_sets = r.counter(
            "lodestar_bls_verifier_planner_sets_total",
            "signature sets routed per kernel path",
            label_names=("path",),
        )
        self.planner_group_size = r.histogram(
            "lodestar_bls_verifier_planner_group_size",
            "sets per group row chosen by the planner",
            buckets=_GROUP_SIZE_BUCKETS,
        )
        self.cache_events = r.counter(
            "lodestar_bls_verifier_cache_events_total",
            "dedup cache hits/misses (h2c roots, pubkey limbs)",
            label_names=("cache", "outcome"),
        )
        self.flushes = r.counter(
            "lodestar_bls_verifier_flushes_total",
            "buffer flushes by trigger reason (size/timer/manual)",
            label_names=("reason",),
        )
        self.flush_seconds = r.histogram(
            "lodestar_bls_verifier_flush_seconds",
            "flush latency: merged batch verify incl. fallback",
            buckets=_STAGE_BUCKETS,
        )
        self.buffer_depth = r.gauge_func(
            "lodestar_bls_verifier_buffer_depth",
            "signature sets currently buffered (live callback, no polling)",
        )
        self.device_busy = r.gauge(
            "lodestar_bls_verifier_device_busy_fraction",
            "fraction of wall time the device spent on verify dispatches",
        )
        # bisection verdicts: per-batch outcome plus
        # round/probe totals — an all-valid batch is one `clean` tick
        # with zero rounds (the ≤1-final-exp fast path); k invalid sets
        # tick `bisected` with O(log N) rounds and O(k·log N) probes
        self.bisect_batches = r.counter(
            "lodestar_bls_verifier_bisect_batches_total",
            "per-set verdict batches by outcome (clean = root passed)",
            label_names=("outcome",),
        )
        self.bisect_rounds_total = r.counter(
            "lodestar_bls_verifier_bisect_rounds_total",
            "bisection rounds walked on failed per-set verdict batches",
        )
        self.bisect_probes_total = r.counter(
            "lodestar_bls_verifier_bisect_probes_total",
            "product-tree nodes probed (batched final exps) during bisection",
        )
        # device-decompress downgrade visibility: the default path
        # silently falling back to host marshal would otherwise be an
        # invisible e2e regression
        self.decompress_fallbacks = r.counter(
            "lodestar_bls_verifier_decompress_fallback_total",
            "device-decompress batches downgraded to host marshal "
            "(native tier ineligible for the batch shape)",
        )
        # supervisor / failure-policy families: the device tier
        # is allowed to fail — these make every branch of the failure
        # policy (chain/supervisor.py) visible. Breaker state encodes
        # closed=0 / half_open=1 / open=2 so dashboards can alert on
        # `> 0` (any degradation) or `== 2` (hard open).
        self.supervisor_breaker_state = r.gauge(
            "lodestar_bls_supervisor_breaker_state",
            "device circuit breaker state (0=closed, 1=half_open, 2=open)",
        )
        self.supervisor_transitions = r.counter(
            "lodestar_bls_supervisor_breaker_transitions_total",
            "circuit breaker state transitions by destination state",
            label_names=("to",),
        )
        self.supervisor_retries = r.counter(
            "lodestar_bls_supervisor_retries_total",
            "device dispatches retried after a transient error",
        )
        self.supervisor_fallbacks = r.counter(
            "lodestar_bls_supervisor_fallbacks_total",
            "dispatches served by the CPU oracle tier, by reason "
            "(exception/deadline/breaker_open/negative_audit)",
            label_names=("reason",),
        )
        self.supervisor_deadline_exceeded = r.counter(
            "lodestar_bls_supervisor_deadline_exceeded_total",
            "device dispatches abandoned at the per-dispatch deadline",
        )
        self.supervisor_canary = r.counter(
            "lodestar_bls_supervisor_canary_probes_total",
            "half-open canary-batch probes by outcome (ok/fail)",
            label_names=("outcome",),
        )
        self.supervisor_both_tiers_failed = r.counter(
            "lodestar_bls_supervisor_both_tiers_failed_total",
            "batches where the device AND the CPU oracle both failed "
            "(waiters resolved False — the only blanket-False path left)",
        )
        self.supervisor_verdict_mismatches = r.counter(
            "lodestar_bls_supervisor_verdict_mismatch_total",
            "device-negative verdicts the CPU oracle overturned "
            "(flaky-device evidence; feeds the breaker)",
        )
        # defense-in-depth for blocked waiters: a wedged flush thread
        # must escalate, not silently deadlock every gossip/import thread
        self.waiter_timeouts = r.counter(
            "lodestar_bls_verifier_waiter_timeouts_total",
            "verify waiters that gave up after the flush-thread timeout",
        )
        # mesh serving: the grouped kernels dispatch across chips when
        # more than one is visible; these families
        # let a dashboard tell a full 4-chip node from a degraded 3-chip
        # one (size + evicted gauges move together on an eviction)
        self.mesh_size = r.gauge(
            "lodestar_bls_mesh_size",
            "chips in the serving BLS dispatch mesh "
            "(0 = unsharded single-device dispatch)",
        )
        self.mesh_evicted = r.gauge(
            "lodestar_bls_mesh_evicted_devices",
            "chips currently evicted from the serving mesh",
        )
        self.mesh_evictions = r.counter(
            "lodestar_bls_mesh_evictions_total",
            "chips evicted from the serving mesh, by failure reason",
            label_names=("reason",),
        )
        self.mesh_readmissions = r.counter(
            "lodestar_bls_mesh_readmissions_total",
            "evicted chips re-admitted after a passing canary probe",
        )
        self.mesh_dispatches = r.counter(
            "lodestar_bls_mesh_chip_dispatch_total",
            "sharded kernel dispatches per participating chip",
            label_names=("chip",),
        )
        # fleet serving: the mesh abstracted over HOSTS — a
        # two-level (DCN × ICI) dispatch layout plus subnet-sharded
        # gossip routing; these families tell a full fleet from one
        # serving degraded after a host eviction
        self.fleet_hosts = r.gauge(
            "lodestar_bls_fleet_hosts",
            "hosts in the two-level serving fleet "
            "(0/1 = single-host, no DCN axis)",
        )
        self.fleet_evicted_hosts = r.gauge(
            "lodestar_bls_fleet_evicted_hosts",
            "hosts currently evicted from the serving fleet",
        )
        self.fleet_host_dispatches = r.counter(
            "lodestar_bls_fleet_host_dispatch_total",
            "two-level sharded dispatches per participating host",
            label_names=("host",),
        )
        self.fleet_dcn = r.counter(
            "lodestar_bls_fleet_dcn_collective_seconds_total",
            "wall seconds spent in DCN-spanning (multi-host) dispatches "
            "— an upper bound on cross-host collective cost",
        )
        self.fleet_host_evictions = r.counter(
            "lodestar_bls_fleet_host_evictions_total",
            "hosts evicted from the serving fleet, by failure reason",
            label_names=("reason",),
        )
        self.fleet_rebalances = r.counter(
            "lodestar_bls_fleet_rebalances_total",
            "subnet-routing rebalances after host eviction/re-admission",
        )
        self.fleet_subnets_moved = r.counter(
            "lodestar_bls_fleet_subnets_moved_total",
            "attestation subnets re-homed across hosts by rebalances",
        )
        # priority-lane dispatcher: continuous batching with
        # admission control — depth per lane, sheds per lane, coalesced
        # batch size, and the double-buffer overlap fraction (how often a
        # batch's host prep overlapped an in-flight device step)
        self.lane_depth = r.gauge(
            "lodestar_bls_lane_depth",
            "signature sets queued per priority lane of the "
            "continuous-batching dispatcher",
            label_names=("lane",),
        )
        self.lane_sheds = r.counter(
            "lodestar_bls_lane_shed_total",
            "signature sets shed by lane admission control or "
            "flood eviction (blocks are never shed)",
            label_names=("lane",),
        )
        self.lane_coalesced_sets = r.histogram(
            "lodestar_bls_lane_coalesced_sets",
            "signature sets coalesced into one lane-dispatcher batch",
            buckets=_GROUP_SIZE_BUCKETS,
        )
        self.lane_overlap_fraction = r.gauge(
            "lodestar_bls_lane_overlap_fraction",
            "fraction of dispatched batches whose host prep overlapped "
            "device compute of an in-flight batch (double-buffering)",
        )
        # epoch-resident crypto: the device pubkey table that
        # turns steady-state attestation marshalling into memcpys, plus
        # the dispatcher's H(msg) dedup at the coalescing point
        # (parallel/epoch_table.py and chain/dispatcher.py feed these)
        self.epoch_table_hits = r.counter(
            "lodestar_bls_epoch_table_hits_total",
            "pubkey rows served from the epoch-resident table "
            "(a memcpy instead of a C-tier G1 decompression)",
        )
        self.epoch_table_misses = r.counter(
            "lodestar_bls_epoch_table_misses_total",
            "pubkey lookups the epoch table could not serve "
            "(fell through to _pk_cache / C-tier decompress)",
        )
        self.epoch_table_occupancy_gauge = r.gauge(
            "lodestar_bls_epoch_table_occupancy",
            "decompressed pubkey rows resident across all retained epochs",
        )
        self.epoch_table_evictions = r.counter(
            "lodestar_bls_epoch_table_evictions_total",
            "pubkey rows dropped by LRU epoch rotation or the row cap",
        )
        self.h2c_dedup_counter = r.counter(
            "lodestar_bls_h2c_dedup_total",
            "duplicate hash-to-curve computations elided by message "
            "dedup at the lane-dispatcher coalescing point",
        )
        # compile-ledger / cold-start families: every library build and
        # first launch, and the getting-to-serving path, as first-class
        # metrics (observability/compile_ledger.py feeds them; the help
        # texts are the JAX package's, which the dashboards share)
        self.compile_events = r.counter(
            "lodestar_tpu_compile_events_total",
            "XLA compile events recorded by the compile ledger, by kernel "
            "and persistent-cache outcome (hit/miss/off)",
            label_names=("kernel", "cache"),
        )
        self.compile_seconds = r.counter(
            "lodestar_tpu_compile_seconds_total",
            "wall seconds spent in first-dispatch kernel compiles",
            label_names=("kernel",),
        )
        self.compile_cumulative = r.gauge(
            "lodestar_tpu_compile_cumulative_seconds",
            "cumulative compile seconds this process (ledger total)",
        )
        self.compile_cache_entries = r.gauge(
            "lodestar_tpu_compile_cache_entries",
            "entries in the persistent XLA compile cache at the last prune",
        )
        self.compile_cache_pruned = r.counter(
            "lodestar_tpu_compile_cache_pruned_bytes_total",
            "bytes the LRU pruner removed from the persistent compile cache",
        )
        self.aot_events = r.counter(
            "lodestar_tpu_aot_events_total",
            "AOT executable-store events by kernel and outcome (hit = "
            "executable loaded from disk instead of compiling, miss = no "
            "artifact, corrupt / version_mismatch = artifact rejected and "
            "degraded to JIT, export = artifact written by the producer)",
            label_names=("kernel", "outcome"),
        )
        self.serving_ready_gauge = r.gauge(
            "lodestar_tpu_serving_ready_seconds",
            "seconds from process start to serving-ready (cold-start SLO; "
            "measured cold vs warm .jax_cache — docs/architecture.md)",
        )
        self.startup_phase_seconds = r.gauge(
            "lodestar_tpu_startup_phase_seconds",
            "seconds from process start to each startup-phase mark "
            "(devices ready, warmup rungs, serving ready)",
            label_names=("phase",),
        )
        self.build_info = r.gauge(
            "lodestar_tpu_build_info",
            "constant 1; labels carry the runtime identity (torch/CUDA "
            "version, backend, device kind/count, mesh divisor, "
            "extension build dir)",
            label_names=BUILD_INFO_LABELS,
        )
        # SLO engine families: the judgment layer over
        # everything above — objectives from dashboards/slo_rules.json
        # evaluated with Google-SRE error budgets and multi-window
        # (5 m / 1 h) burn rates (observability/slo.py feeds them)
        self.slo_burning = r.gauge(
            "lodestar_slo_burning",
            "1 while an SLO objective is burning its error budget on "
            "BOTH the short and long window (alert on == 1)",
            label_names=("objective",),
        )
        self.slo_budget_remaining = r.gauge(
            "lodestar_slo_budget_remaining_fraction",
            "fraction of an objective's error budget left since the "
            "engine started (1 = untouched, 0 = exhausted)",
            label_names=("objective",),
        )
        self.slo_burn_rate = r.gauge(
            "lodestar_slo_burn_rate",
            "error-budget burn rate per evaluation window (1.0 = burning "
            "exactly the sustainable rate; zero-tolerance objectives "
            "report raw bad-event counts)",
            label_names=("objective", "window"),
        )
        self.slo_evaluations = r.counter(
            "lodestar_slo_evaluations_total",
            "SLO engine evaluation passes (scrapes, bench sections, "
            "supervisor pokes)",
        )
        # device-time & memory ledger families: where
        # device-seconds and HBM bytes actually go, by lane x kernel x
        # chip (observability/device_ledger.py feeds them)
        self.device_dispatch_seconds = r.counter(
            "lodestar_tpu_device_dispatch_seconds_total",
            "busy device-seconds attributed per lane x kernel x chip "
            "(each participating chip accrues the full dispatch time)",
            label_names=("lane", "kernel", "chip"),
        )
        self.device_overlap_seconds = r.counter(
            "lodestar_tpu_device_overlap_seconds_total",
            "device-seconds spent while another dispatch was already in "
            "flight (double-buffering overlap), same key as dispatch time",
            label_names=("lane", "kernel", "chip"),
        )
        self.device_idle_wall = r.gauge(
            "lodestar_tpu_device_idle_wall_seconds",
            "wall seconds with NO dispatch in flight since the device "
            "ledger started (refreshed on snapshot)",
        )
        self.device_memory = r.gauge(
            "lodestar_tpu_device_memory_bytes",
            "sampled jax device memory by chip and kind "
            "(in_use/peak/limit/live_buffers)",
            label_names=("chip", "kind"),
        )
        self.device_memory_watermark = r.gauge(
            "lodestar_tpu_device_memory_watermark_bytes",
            "high watermark of sampled in-use device memory per chip "
            "(monotonic within a process)",
            label_names=("chip",),
        )
        # device-busy sampler state: busy seconds accumulate per resolve,
        # the fraction is re-sampled over >=1 s wall windows
        self._busy_lock = threading.Lock()
        self._busy_accum = 0.0
        self._busy_window_t0 = time.monotonic()
        # lane-dispatcher state: overlap fraction is maintained from
        # batch counters; the live per-lane depth callback is bound by
        # the dispatcher (None until one wires up — `lanes_snapshot()`
        # then reports unwired)
        self._lane_lock = threading.Lock()
        self._lane_batches = 0
        self._lane_overlapped = 0
        self._lane_depths_fn = None
        # the process-wide compile ledger fans its events out to every
        # live pipeline: the node registry and the bench/tools default
        # pipeline both see the same compile history (weakref — a
        # discarded test registry detaches itself)
        from .compile_ledger import ledger as _compile_ledger

        _compile_ledger().attach(self)
        # same fan-out contract for the device-time & memory ledger
        from .device_ledger import ledger as _device_ledger

        _device_ledger().attach(self)

    # -- stage timers -------------------------------------------------------

    def stage(self, name: str) -> _StageTimer:
        return _StageTimer(self, name)

    def observe_stage(self, name: str, seconds: float) -> None:
        self.stage_seconds.observe(seconds, stage=name)

    # -- planner ------------------------------------------------------------

    def planner(self, path: str, n_sets: int, group_sizes=None) -> None:
        self.planner_decisions.inc(path=path)
        self.planner_sets.inc(n_sets, path=path)
        if group_sizes:
            for size in group_sizes:
                self.planner_group_size.observe(size)
        flight_recorder.record("dispatch", path=path, sets=n_sets)

    def cache_event(self, cache: str, hit: bool, n: int = 1) -> None:
        if n:
            self.cache_events.inc(n, cache=cache, outcome="hit" if hit else "miss")

    def epoch_table_event(self, hit: bool, n: int = 1) -> None:
        if n:
            (self.epoch_table_hits if hit else self.epoch_table_misses).inc(n)

    def epoch_table_occupancy(self, rows: int) -> None:
        self.epoch_table_occupancy_gauge.set(rows)

    def epoch_table_eviction(self, n: int = 1) -> None:
        if n:
            self.epoch_table_evictions.inc(n)

    def h2c_dedup(self, n: int = 1) -> None:
        if n:
            self.h2c_dedup_counter.inc(n)

    def bisect(self, rounds: int, probes: int) -> None:
        """Record one per-set verdict batch's bisection outcome."""
        self.bisect_batches.inc(
            outcome="clean" if rounds == 0 else "bisected"
        )
        if rounds:
            self.bisect_rounds_total.inc(rounds)
        if probes:
            self.bisect_probes_total.inc(probes)

    def decompress_fallback(self, n: int = 1) -> None:
        self.decompress_fallbacks.inc(n)

    # -- supervisor / failure policy ----------------------------------------

    def breaker_state(self, value: int, to: str | None = None) -> None:
        """Set the breaker-state gauge; `to` also ticks the transition
        counter (passed on actual transitions, not on re-assertions)."""
        self.supervisor_breaker_state.set(value)
        if to is not None:
            self.supervisor_transitions.inc(to=to)
            flight_recorder.record("breaker", to=to, state=value)

    def supervisor_retry(self) -> None:
        self.supervisor_retries.inc()

    def supervisor_fallback(self, reason: str, n_sets: int = 0) -> None:
        self.supervisor_fallbacks.inc(reason=reason)
        flight_recorder.record("fallback", reason=reason, sets=n_sets)

    def supervisor_deadline(self) -> None:
        self.supervisor_deadline_exceeded.inc()
        flight_recorder.record("deadline_exceeded")

    def supervisor_canary_probe(self, ok: bool) -> None:
        self.supervisor_canary.inc(outcome="ok" if ok else "fail")

    def both_tiers_failed(self) -> None:
        self.supervisor_both_tiers_failed.inc()

    def verdict_mismatch(self, n: int = 1) -> None:
        self.supervisor_verdict_mismatches.inc(n)

    def waiter_timeout(self) -> None:
        self.waiter_timeouts.inc()

    # -- mesh serving -------------------------------------------------------

    def mesh_state(self, size: int, evicted: int) -> None:
        """Assert the current serving-mesh shape (size + evicted gauges)."""
        self.mesh_size.set(size)
        self.mesh_evicted.set(evicted)

    def mesh_eviction(self, chip: int, reason: str) -> None:
        self.mesh_evictions.inc(reason=reason)
        flight_recorder.record("mesh_eviction", chip=chip, reason=reason)

    def mesh_readmission(self, n: int = 1) -> None:
        self.mesh_readmissions.inc(n)
        flight_recorder.record("mesh_readmission", chips=n)

    def mesh_dispatch(self, chips) -> None:
        """Tick the per-chip dispatch counter for every participating chip
        of one sharded dispatch."""
        for chip in chips:
            self.mesh_dispatches.inc(chip=str(chip))

    # -- fleet serving ------------------------------------------------------

    def fleet_state(self, hosts: int, evicted: int) -> None:
        """Assert the current fleet shape (serving + evicted host gauges)."""
        self.fleet_hosts.set(hosts)
        self.fleet_evicted_hosts.set(evicted)

    def fleet_dispatch(self, hosts) -> None:
        """Tick the per-host dispatch counter for every participating host
        of one two-level (DCN-spanning) dispatch."""
        for host in hosts:
            self.fleet_host_dispatches.inc(host=str(host))

    def fleet_dcn_seconds(self, seconds: float) -> None:
        self.fleet_dcn.inc(max(seconds, 0.0))

    def fleet_host_eviction(self, host: int, reason: str) -> None:
        self.fleet_host_evictions.inc(reason=reason)
        flight_recorder.record("fleet_host_eviction", host=host,
                               reason=reason)

    def fleet_rebalance(self, subnets_moved: int) -> None:
        self.fleet_rebalances.inc()
        if subnets_moved:
            self.fleet_subnets_moved.inc(subnets_moved)
        flight_recorder.record("fleet_rebalance", subnets=subnets_moved)

    # -- priority-lane dispatcher -------------------------------------------

    def bind_lane_depths(self, fn) -> None:
        """Register the dispatcher's live lane-state callback (feeds
        `/debug/lanes` and `lanes_snapshot()`)."""
        self._lane_depths_fn = fn
        for lane in ("block", "sync_committee", "aggregate", "attestation"):
            self.lane_depth.set(0, lane=lane)
        # initialize the overlap gauge too: a scrape before the first
        # flood must see 0.0, not an absent series
        self.lane_overlap_fraction.set(0.0)

    def lane_depth_set(self, lane: str, n_sets: int) -> None:
        self.lane_depth.set(n_sets, lane=lane)

    def lane_shed(self, lane: str, n_sets: int) -> None:
        self.lane_sheds.inc(n_sets, lane=lane)
        flight_recorder.record("lane_shed", lane=lane, sets=n_sets)

    def lane_coalesce(self, n_sets: int) -> None:
        self.lane_coalesced_sets.observe(n_sets)

    def lane_overlap(self, overlapped: bool) -> None:
        with self._lane_lock:
            self._lane_batches += 1
            if overlapped:
                self._lane_overlapped += 1
            self.lane_overlap_fraction.set(
                self._lane_overlapped / self._lane_batches
            )

    def lanes_snapshot(self) -> dict | None:
        """Lane-dispatcher state for the bench document and `/debug/lanes`;
        None until a dispatcher binds its depth callback."""
        if self._lane_depths_fn is None:
            return None
        sheds = {
            labels.get("lane", ""): int(v)
            for labels, v in self.lane_sheds.collect()
        }
        with self._lane_lock:
            batches = self._lane_batches
            overlapped = self._lane_overlapped
        snap = dict(self._lane_depths_fn())
        snap["sheds"] = sheds
        snap["batches"] = batches
        snap["overlapped_batches"] = overlapped
        snap["overlap_fraction"] = (
            round(overlapped / batches, 4) if batches else 0.0
        )
        return snap

    # -- compile ledger / cold start ----------------------------------------

    def compile_event(self, kernel: str, cache: str, seconds: float,
                      cumulative_s: float | None = None) -> None:
        """One first-dispatch compile observed by the ledger (the ledger
        fans this out to every live pipeline — don't call directly)."""
        self.compile_events.inc(kernel=kernel, cache=cache)
        self.compile_seconds.inc(seconds, kernel=kernel)
        if cumulative_s is not None:
            self.compile_cumulative.set(cumulative_s)

    def aot_event(self, kernel: str, outcome: str) -> None:
        """One AOT-store event observed by the compile ledger (the ledger
        fans this out to every live pipeline — don't call directly)."""
        self.aot_events.inc(kernel=kernel, outcome=outcome)

    def cache_pruned(self, removed_bytes: int, entries_remaining: int) -> None:
        """One prune pass of the build cache."""
        if removed_bytes:
            self.compile_cache_pruned.inc(removed_bytes)
        self.compile_cache_entries.set(entries_remaining)

    def startup_phase(self, phase: str, seconds: float) -> None:
        self.startup_phase_seconds.set(seconds, phase=phase)

    def serving_ready(self, seconds: float) -> None:
        self.serving_ready_gauge.set(seconds)

    def set_build_info(self, info: dict) -> None:
        """Export the runtime identity as the constant-1 build-info gauge
        (missing keys render as "unknown" so a partial dict never throws
        a label mismatch at startup)."""
        labels = {
            k: str(info.get(k, "unknown")) for k in BUILD_INFO_LABELS
        }
        self.build_info.set(1, **labels)

    # -- SLO engine ---------------------------------------------------------

    def slo_report(self, objective: str, burning: bool,
                   budget_remaining: float, burn_short: float,
                   burn_long: float) -> None:
        """One objective's state after an engine evaluation (the SLO
        engine fans this out — don't call directly)."""
        self.slo_burning.set(1 if burning else 0, objective=objective)
        self.slo_budget_remaining.set(budget_remaining, objective=objective)
        self.slo_burn_rate.set(burn_short, objective=objective, window="short")
        self.slo_burn_rate.set(burn_long, objective=objective, window="long")

    def slo_evaluated(self) -> None:
        self.slo_evaluations.inc()

    # -- device-time & memory ledger ----------------------------------------

    def device_dispatch_time(self, lane: str, kernel: str, chip: str,
                             busy_s: float, overlap_s: float = 0.0) -> None:
        """One dispatch's attributed device time for one chip (the device
        ledger fans this out — don't call directly)."""
        self.device_dispatch_seconds.inc(
            busy_s, lane=lane, kernel=kernel, chip=chip
        )
        if overlap_s:
            self.device_overlap_seconds.inc(
                overlap_s, lane=lane, kernel=kernel, chip=chip
            )

    def device_idle(self, idle_s: float) -> None:
        self.device_idle_wall.set(idle_s)

    def device_memory_sample(self, chip: str, kind: str, value: float) -> None:
        self.device_memory.set(value, chip=chip, kind=kind)

    def device_memory_watermark_set(self, chip: str, value: float) -> None:
        self.device_memory_watermark.set(value, chip=chip)

    # -- queue / flush ------------------------------------------------------

    def bind_buffer_depth(self, fn) -> None:
        self.buffer_depth.set_function(fn)

    def flush(self, reason: str, latency_s: float | None = None) -> None:
        self.flushes.inc(reason=reason)
        if latency_s is not None:
            self.flush_seconds.observe(latency_s)

    def device_busy_sample(self, busy_s: float) -> None:
        """Accumulate one dispatch's device-busy seconds; refresh the
        busy-fraction gauge once per >=1 s wall window (short windows are
        all noise at ms dispatch times)."""
        now = time.monotonic()
        with self._busy_lock:
            self._busy_accum += busy_s
            elapsed = now - self._busy_window_t0
            if elapsed >= 1.0:
                self.device_busy.set(min(1.0, self._busy_accum / elapsed))
                self._busy_accum = 0.0
                self._busy_window_t0 = now

    # -- snapshots (bench emitter) -----------------------------------------

    def stage_snapshot(self) -> dict:
        """{stage: {"sum_s", "count"}} for every stage observed so far."""
        out = {}
        for labels, _ in self.stage_seconds._counts.items():
            stage = labels[0]
            out[stage] = {
                "sum_s": round(self.stage_seconds._sums[labels], 6),
                "count": self.stage_seconds._totals[labels],
            }
        return out

    def planner_snapshot(self) -> dict:
        decisions = {
            labels.get("path", ""): int(v)
            for labels, v in self.planner_decisions.collect()
        }
        sets = {
            labels.get("path", ""): int(v)
            for labels, v in self.planner_sets.collect()
        }
        caches = {
            f'{labels["cache"]}_{labels["outcome"]}': int(v)
            for labels, v in self.cache_events.collect()
        }
        return {"decisions": decisions, "sets": sets, "cache_events": caches}

    def bisect_snapshot(self) -> dict:
        """Bisection-verdict counters for the bench document: batch
        outcomes, total rounds walked, total nodes probed, and the
        decompress→host-marshal downgrade count."""
        outcomes = {
            labels.get("outcome", ""): int(v)
            for labels, v in self.bisect_batches.collect()
        }
        return {
            "batches": outcomes,
            "rounds": int(self.bisect_rounds_total.value()),
            "probes": int(self.bisect_probes_total.value()),
            "decompress_fallbacks": int(self.decompress_fallbacks.value()),
        }

    def mesh_snapshot(self) -> dict:
        """Mesh-serving counters for the bench document and `/debug/mesh`:
        current shape, eviction/re-admission history, per-chip dispatches."""
        evictions = {
            labels.get("reason", ""): int(v)
            for labels, v in self.mesh_evictions.collect()
        }
        dispatches = {
            labels.get("chip", ""): int(v)
            for labels, v in self.mesh_dispatches.collect()
        }
        return {
            "size": int(self.mesh_size.value()),
            "evicted": int(self.mesh_evicted.value()),
            "evictions": evictions,
            "readmissions": int(self.mesh_readmissions.value()),
            "chip_dispatches": dispatches,
        }

    def fleet_snapshot(self) -> dict:
        """Fleet-serving counters for the bench document and
        `/debug/fleet`: host gauges, per-host dispatches, DCN seconds and
        the eviction/rebalance history."""
        evictions = {
            labels.get("reason", ""): int(v)
            for labels, v in self.fleet_host_evictions.collect()
        }
        dispatches = {
            labels.get("host", ""): int(v)
            for labels, v in self.fleet_host_dispatches.collect()
        }
        return {
            "hosts": int(self.fleet_hosts.value()),
            "evicted_hosts": int(self.fleet_evicted_hosts.value()),
            "host_evictions": evictions,
            "host_dispatches": dispatches,
            "dcn_collective_seconds": round(self.fleet_dcn.value(), 6),
            "rebalances": int(self.fleet_rebalances.value()),
            "subnets_moved": int(self.fleet_subnets_moved.value()),
        }

    def supervisor_snapshot(self) -> dict:
        """Failure-policy counters for a report and `/debug/breaker`.
        `degraded` is the one-bit summary a regression gate keys on: a
        run that took any CPU fallback, an open breaker, or an armed fault
        plan is not comparing the device path. The fault plan is the
        injected `faults` object's `snapshot()`, none armed without one."""
        fallbacks = {
            labels.get("reason", ""): int(v)
            for labels, v in self.supervisor_fallbacks.collect()
        }
        canary = {
            labels.get("outcome", ""): int(v)
            for labels, v in self.supervisor_canary.collect()
        }
        fault_snap = (self._faults.snapshot() if self._faults is not None
                      else {"active": False, "modes": {}, "injected": {}})
        snap = {
            "breaker_state": int(self.supervisor_breaker_state.value()),
            "fallbacks": fallbacks,
            "retries": int(self.supervisor_retries.value()),
            "deadline_exceeded": int(self.supervisor_deadline_exceeded.value()),
            "canary": canary,
            "both_tiers_failed": int(
                self.supervisor_both_tiers_failed.value()
            ),
            "verdict_mismatches": int(
                self.supervisor_verdict_mismatches.value()
            ),
            "waiter_timeouts": int(self.waiter_timeouts.value()),
            "faults": fault_snap,
        }
        # negative_audit alone is NOT degradation: auditing a genuinely
        # invalid batch on the oracle is the healthy-path design
        tier_fallbacks = sum(
            v for k, v in fallbacks.items() if k != "negative_audit"
        )
        snap["degraded"] = bool(
            snap["breaker_state"]
            or tier_fallbacks
            or snap["deadline_exceeded"]
            or snap["both_tiers_failed"]
            or snap["verdict_mismatches"]
            or fault_snap["active"]
            or fault_snap["injected"]
            # a mesh currently missing chips serves real traffic but its
            # throughput is not comparable to a full-mesh run
            or int(self.mesh_evicted.value())
        )
        return snap


def create_pipeline_metrics(registry: MetricsRegistry) -> PipelineMetrics:
    """Register the pipeline families on an existing node registry."""
    return PipelineMetrics(registry)


_default: PipelineMetrics | None = None
_default_lock = threading.Lock()


def default_pipeline() -> PipelineMetrics:
    """The process-wide instance every verifier, facade and epoch table
    records into when no observer is passed."""
    global _default
    with _default_lock:
        if _default is None:
            _default = PipelineMetrics()
        return _default


def peek_default() -> PipelineMetrics | None:
    """The default pipeline IF one already exists — never creates one, so
    ticking a counter does not spin up a registry in a process that never
    had one."""
    with _default_lock:
        return _default


def _noop(*_args, **_kwargs) -> None:
    return None


class NullObserver:
    """Every `PipelineMetrics` method as a no-op, for callers that ask for
    no recording (`observer=NULL_OBSERVER`)."""

    def stage(self, _name: str):
        return contextlib.nullcontext()

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return _noop


NULL_OBSERVER = NullObserver()
