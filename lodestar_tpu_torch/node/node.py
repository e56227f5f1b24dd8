"""BeaconNode composition root.

Reference: `beacon-node/src/node/nodejs.ts:127-270` — wiring order
db.start → metrics → chain → network → sync → api server → metrics server;
`close()` persists the chain state back to the db (nodejs.ts:275-290).

The port's copy of the JAX package's `node/node.py`. Where the JAX node
branches on the environment, this one takes an argument:

- `device` in place of `tpu_verifier`: the node builds the port's serving
  stack (`bls_stack.build_bls_stack`) on that device, the GPU by default
  (raises without one); "cpu" runs the stack on the kernels' plain
  versions. `verifier=` hands it one already built instead (the caller
  stops it), as `BeaconChain(verifier=)` takes one; `supervisor=` (a
  stack's `SupervisedBlsVerifier`) has the node compose its own lane
  dispatcher over it, recording into the node's registry, as the JAX node
  composes `BlsLaneDispatcher(self.bls_supervisor, prom=self.metrics)`.
- in place of `enable_compile_cache` and `preload_aot`, the node preloads
  its stack's libraries from the library store
  (`compile_ledger.preload_aot`) before it declares itself ready, then
  sets the process's kernel launch counts to 0, so that they count the
  node's own verdicts.
- `fleet` (a `parallel.fleet.FleetRouter`, or None) and `fleet_ingest`
  in place of `FleetTopology.from_env()` and `LODESTAR_TPU_FLEET_INGEST`.
- `clock`: the chain's clock (default the chain's manual clock, which
  `on_clock_slot` sets from the wall clock the CLI follows).
- the build-info gauge carries `observability/runtime.py`'s identity.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

from ..api import BeaconApiServer
from ..api.impl import BeaconApiImpl
from ..chain.chain import BeaconChain
from ..db import BeaconDb
from ..db.controller import FileDb, MemoryDb
from ..metrics.beacon import create_beacon_metrics
from ..metrics.server import MetricsServer
from .init_state import persist_state
from .notifier import NodeNotifier


@dataclass
class NodeOptions:
    """Reference: IBeaconNodeOptions (`node/options.ts`) — the flag tree the
    CLI maps 1:1 onto."""

    datadir: str | None = None  # None → in-memory db
    db_controller: object | None = None  # pre-opened controller wins over datadir
    rest: bool = True
    rest_port: int = 0
    rest_bearer_token: str | None = None  # require Authorization: Bearer …
    rest_cors_origin: str | None = None  # Access-Control-Allow-Origin value
    metrics: bool = False
    metrics_port: int = 0
    device: str | None = None  # the stack's device; None → the GPU
    verifier: object | None = None  # an already-built IBlsVerifier (the caller's)
    supervisor: object | None = None  # a built SupervisedBlsVerifier: the node adds lanes
    clock: object | None = None  # the chain's clock; None → the chain's manual clock
    fleet: object | None = None  # a FleetRouter for subnet-sliced ingest; None → none
    fleet_ingest: bool = False  # bind `fleet` into the gossip handlers
    execution_engine: object | None = None
    eth1_provider: object | None = None  # IEth1Provider (mock or HTTP)
    notifier_interval_slots: int = 1


class BeaconNode:
    """Owns every service; `BeaconNode.init(...)` is the only constructor
    path (reference pattern)."""

    def __init__(self):
        raise TypeError("use BeaconNode.init()")

    @classmethod
    def init(cls, config, types, anchor_state, opts: NodeOptions | None = None):
        self = object.__new__(cls)
        opts = opts or NodeOptions()
        self.opts = opts
        self.config = config
        self.types = types
        self.log = logging.getLogger("node")
        self.stack = self.lanes = self.chain = self.db = None
        self.api_server = self.metrics_server = None
        self._slo_engine = self._trace_hook = None
        try:
            self._compose(config, types, anchor_state, opts)
        except BaseException:
            self._stop()  # what was started before the failure
            raise
        return self

    def _compose(self, config, types, anchor_state, opts) -> None:
        # cold-start timeline: marks are seconds since PROCESS start, so
        # interpreter+import time counts toward the serving-ready SLO
        from ..observability.compile_ledger import timeline

        timeline().mark("node_init")

        # 1. db
        if opts.db_controller is not None:
            controller = opts.db_controller
        else:
            controller = FileDb(opts.datadir) if opts.datadir else MemoryDb()
        self.db = BeaconDb(types, controller)

        # 2. metrics + per-validator monitor (reference validatorMonitor
        # wired at node init; register indices via monitor_validators())
        self.metrics = create_beacon_metrics()
        from ..state_transition import stf as _stf

        _stf.set_metrics(self.metrics)
        from ..metrics.validator_monitor import ValidatorMonitor

        self.validator_monitor = ValidatorMonitor(self.metrics.registry)
        from ..metrics.gc_stats import install_gc_metrics

        install_gc_metrics(self.metrics.registry)

        # 3. the verifier: the serving stack over the node's registry
        # (lanes > supervisor > device, the host tier as fallback and audit),
        # or the caller's
        from ..observability import device_ledger, slo, spans as _spans

        self.tracer = _spans.tracer
        self.bls_supervisor = opts.supervisor
        if opts.verifier is not None:
            verifier = opts.verifier
        elif opts.supervisor is not None:
            from ..chain.dispatcher import BlsLaneDispatcher

            self.lanes = verifier = BlsLaneDispatcher(
                opts.supervisor, prom=self.metrics, pipeline=self.metrics.pipeline)
        else:
            from ..observability.compile_ledger import ledger
            from .bls_stack import build_bls_stack

            self.stack = build_bls_stack(device=opts.device, observer=self.metrics.pipeline)
            self.bls_supervisor, verifier = self.stack.supervisor, self.stack.verifier
            # crash-safe warm boot: open every library of the store for this
            # build (and launch each kernel once on a card) before the node
            # is ready; a missing or refused library is rebuilt at first use
            aot = ledger().preload_aot(device=self.stack.device.device)
            if aot["loaded"]:
                self.log.info("library store: %d librar(ies) loaded in %.2fs",
                              len(aot["loaded"]), aot["seconds"])
            # the process's launch counts start at 0 here, past the
            # preload's launches and before any request is served: what they
            # read later is the node's verdicts alone
            from ..parallel.mesh_pool import launch_counts

            launch_counts(reset=True)
        if self.stack is None:
            # lifecycle tracing on this node's registry; a stack the node
            # built counts them itself. Re-init (tests, in-process restart)
            # REPLACES the node hook so a dead registry stops receiving counts.
            def _count_trace(doc, _m=self.metrics):
                kind = (doc.get("attrs") or {}).get("kind") or doc["name"]
                _m.lifecycle_traces_total.inc(kind=kind)

            _count_trace._node_wired = True
            self._trace_hook = _count_trace
            self.tracer.on_finish[:] = [
                cb for cb in self.tracer.on_finish
                if not getattr(cb, "_node_wired", False)
            ] + [_count_trace]
        # fleet ingest routing: this host validates only its subnet slice of
        # attestation gossip (parallel/fleet.py; wired into the gossip
        # handlers at attach_network)
        self.fleet_router = opts.fleet
        if self.fleet_router is not None and self.bls_supervisor is not None:
            try:
                self.bls_supervisor.fleet_attach_router(self.fleet_router)
            except Exception:  # noqa: BLE001 — wiring must not kill init
                self.log.debug("fleet router mesh attach failed", exc_info=True)
        self.chain = BeaconChain(
            config,
            types,
            anchor_state,
            verifier=verifier,
            clock=opts.clock,
            db=self.db,
            execution_engine=opts.execution_engine,
        )
        self.chain.metrics = self.metrics
        if hasattr(self.db.db, "metrics"):
            self.db.db.metrics = self.metrics
        self.chain.validator_monitor = self.validator_monitor

        # 3b. eth1 deposit follower (live JSON-RPC or mock; None = none)
        self.eth1_tracker = None
        if opts.eth1_provider is not None:
            from ..eth1 import Eth1DepositTracker

            self.eth1_tracker = Eth1DepositTracker(
                config, types, opts.eth1_provider
            )
            self.chain.eth1_tracker = self.eth1_tracker

        # 4. network + sync are attached by the caller once a transport
        # exists (dev mode runs networkless, like reference dev w/o peers)
        self.peers = []
        self.sync = None
        self.network = None

        # 5. servers
        if opts.rest:
            impl = BeaconApiImpl(config, types, self.chain)
            self.api_server = BeaconApiServer(
                impl, port=opts.rest_port, metrics=self.metrics,
                bearer_token=opts.rest_bearer_token,
                cors_origin=opts.rest_cors_origin,
            )
            self.api_server.start()
            self.log.info("REST API on :%d", self.api_server.port)
        # SLO engine over the node's live pipeline: /debug/slo, the
        # lodestar_slo_* families and supervisor pokes all read it (a stack
        # installs its own; an engine the caller's stack installed is left)
        if self.stack is None and slo.engine() is None:
            self._slo_engine = slo.install(self.metrics.pipeline)
        if opts.metrics:
            sup = self.bls_supervisor
            self.metrics_server = MetricsServer(
                self.metrics.registry, port=opts.metrics_port,
                tracer=self.tracer,
                breaker=getattr(sup, "breaker_snapshot", None),
                mesh=getattr(sup, "mesh_snapshot", None),
                fleet=self._fleet_debug_snapshot,
                lanes=self.metrics.pipeline.lanes_snapshot,
                slo=slo.snapshot_or_none,
                device=device_ledger.ledger().snapshot,
                epoch_table=getattr(sup, "epoch_table_snapshot", None),
            )
            self.metrics_server.start()
            self.log.info("metrics on :%d", self.metrics_server.port)

        self.notifier = NodeNotifier(self, opts.notifier_interval_slots)

        # runtime identity on /metrics (lodestar_tpu_build_info) + the
        # serving-ready SLO mark: init returning IS this node's ready point
        from ..observability.runtime import runtime_info

        self.metrics.pipeline.set_build_info(runtime_info())
        ready_s = timeline().mark_serving_ready()
        self.log.info("serving-ready %.2fs after process start", ready_s)

    def attach_network(self, network) -> None:
        """Bind a started Network: REST node-identity/peers routes and the
        sync layer see it (reference nodejs.ts wiring order §3.1). A
        fleet node with `fleet_ingest` also binds its subnet router into the
        gossip handlers so foreign-slice attestations are dropped
        pre-validation."""
        self.network = network
        if self.api_server is not None:
            self.api_server.impl.network = network
        handlers = getattr(network, "gossip_handlers", None)
        if self.fleet_router is not None and handlers is not None and self.opts.fleet_ingest:
            handlers.fleet_router = self.fleet_router

    def _fleet_debug_snapshot(self):
        """Zero-arg provider for `/debug/fleet`: the two-level mesh census
        (with the router's slice state) when the device tier serves a
        fleet, else the bare router view, else None (wired: false)."""
        snap = None
        if self.bls_supervisor is not None:
            try:
                snap = self.bls_supervisor.fleet_snapshot()
            except Exception:  # noqa: BLE001 — debug surface must not raise
                snap = None
        if snap is None and self.fleet_router is not None:
            snap = {"router": self.fleet_router.snapshot()}
        if snap is not None:
            snap["counters"] = self.metrics.pipeline.fleet_snapshot()
        return snap

    # -- slot driving --------------------------------------------------------

    def monitor_validators(self, indices) -> None:
        """Register validator indices for per-duty tracking (reference
        --monitoredValidators flag → validatorMonitor)."""
        for i in indices:
            self.validator_monitor.register_validator(int(i))

    def on_clock_slot(self, slot: int) -> None:
        """Per-slot housekeeping: clock, fork-choice time, prepared state,
        metrics, status line."""
        clock = self.chain.clock
        if hasattr(clock, "set_slot"):
            clock.set_slot(slot)
        self.chain.fork_choice.update_time(slot)
        self.chain.prepare_next_slot.on_slot(slot)
        self._follow_eth1_async()
        m = self.metrics
        m.head_slot.set(self.chain.head_state.state.slot)
        m.clock_slot.set(slot)
        m.clock_epoch.set(slot // self.config.preset.SLOTS_PER_EPOCH)
        m.head_distance.set(max(0, slot - self.chain.head_state.state.slot))
        try:
            m.active_validators.set(
                len(
                    self.chain.head_state.flat.active_indices(
                        slot // self.config.preset.SLOTS_PER_EPOCH
                    )
                )
            )
        except Exception as e:
            # phase0 test states lack the flat active-index path
            self.log.debug("active-validator gauge update failed: %s", e)
        m.current_justified_epoch.set(self.chain.justified_checkpoint[0])
        m.finalized_epoch.set(self.chain.finalized_checkpoint[0])
        m.state_cache_size.set(len(self.chain.state_cache._cache))
        m.fork_choice_nodes.set(len(self.chain.fork_choice.proto.nodes))
        m.fork_choice_votes.set(len(self.chain.fork_choice._vote_next))
        m.proposer_boost_active.set(
            1 if self.chain.fork_choice.proposer_boost_root else 0
        )
        for kind, cache in (
            ("attesters", self.chain.seen_attesters),
            ("aggregators", self.chain.seen_aggregators),
            ("block_proposers", self.chain.seen_block_proposers),
            ("aggregated", self.chain.seen_aggregated),
            ("sync_committee", self.chain.seen_sync_committee),
        ):
            try:
                m.seen_cache_size.set(len(cache._seen), kind=kind)
            except (AttributeError, TypeError):
                pass
        # h2c cache size via the DeviceBlsVerifier seam (the facades
        # delegate); CpuBlsVerifier has no cache — gauge stays 0
        sizer = getattr(self.chain.bls, "h2c_cache_size", None)
        if callable(sizer):
            m.h2c_cache_size.set(sizer())
        # 0 stalled / 1 syncing / 2 synced: synced = within one slot of
        # the clock; stalled = behind AND head unchanged for >3 slots
        head = self.chain.head_state.state.slot
        if slot - head <= 1:
            m.sync_status.set(2)
            self._head_progress = (head, slot)
        else:
            last_head, last_slot = getattr(self, "_head_progress", (head, slot))
            if head > last_head:
                self._head_progress = (head, slot)
                m.sync_status.set(1)
            elif slot - last_slot > 3:
                m.sync_status.set(0)
            else:
                m.sync_status.set(1)
        pool = self.chain.attestation_pool
        m.op_pool_size.set(
            sum(len(v) for v in pool._by_slot.values())
            if hasattr(pool, "_by_slot")
            else 0,
            kind="attestations",
        )
        m.op_pool_size.set(len(self.chain.op_pool.voluntary_exits), kind="exits")
        m.op_pool_size.set(
            len(self.chain.op_pool.attester_slashings), kind="attester_slashings"
        )
        spe = self.config.preset.SLOTS_PER_EPOCH
        if slot % spe == 0:
            # epoch transition: pre-populate the device-resident pubkey
            # table for the new epoch's active set — off the slot path,
            # one population in flight at a time
            self._populate_epoch_table_async(slot // spe)
        if slot % spe == 0 and self.validator_monitor.monitored:
            epoch_now = slot // spe
            if epoch_now >= 2:
                self.validator_monitor.on_balances(
                    epoch_now - 2, self.chain.head_state.state.balances
                )
                self.validator_monitor.log_epoch(epoch_now - 2, self.log)
        stats = getattr(self.db.db, "stats", None)
        if callable(stats):
            st = stats()
            m.db_entries.set(st["entries"])
            m.db_live_bytes.set(st["live_bytes"])
            m.db_dead_bytes.set(st["dead_bytes"])
        self.notifier.on_slot(slot)

    def _populate_epoch_table_async(self, epoch: int) -> None:
        """Decompress the epoch's active-validator pubkeys into the
        device-resident `EpochPubkeyTable` on a background thread, through
        the stack's `populate_epoch_async` (at most one population in
        flight). Committees are fixed per epoch, so after this the
        attestation lanes read pubkey limbs with a copy instead of a C-tier
        square root. A node without a stack (a caller's verifier) skips it."""
        if self.stack is None:
            return
        try:
            flat = self.chain.head_state.flat
            indices = flat.active_indices(epoch)
            pubkeys = [bytes(flat.pubkeys[int(i)]) for i in indices]
        except Exception as e:
            # phase0 test states lack the flat active-index path
            self.log.debug("epoch-table population skipped: %s", e)
            return
        self.stack.populate_epoch_async(epoch, pubkeys)

    def _follow_eth1_async(self) -> None:
        """Kick the deposit-log follower on a background thread, at most
        one catch-up in flight (reference: periodic eth1 update loop —
        the initial historical sync can take minutes and must never block
        the slot path or a proposal)."""
        tracker = self.eth1_tracker
        if tracker is None or getattr(self, "_eth1_following", False):
            return
        self._eth1_following = True

        def _run():
            try:
                tracker.follow()
            except Exception as e:
                self.log.warning("eth1 follow failed: %s", e)
            finally:
                self._eth1_following = False

        threading.Thread(target=_run, name="eth1follow", daemon=True).start()

    def run(self, slots: int, slot_time: float = 0.0, on_slot=None) -> None:
        """Drive `slots` wall-clock slots (dev/test; production would follow
        the genesis-anchored clock)."""
        start = self.chain.head_state.state.slot
        for slot in range(start + 1, start + slots + 1):
            if on_slot is not None:
                on_slot(slot)
            self.on_clock_slot(slot)
            if slot_time > 0:
                time.sleep(slot_time)

    # -- shutdown ------------------------------------------------------------

    def close(self) -> None:
        """Persist the head state then stop servers, the stack the node
        built and the db (reference BeaconNode.close → chain.persistToDisk)."""
        try:
            head = self.chain.head_state
            head.sync_flat()
            persist_state(self.db, head.state, head.fork)
        except Exception as e:  # persist is best-effort on shutdown
            self.log.error("state persist failed: %s", e)
        self._stop()

    def _stop(self) -> None:
        """Stop whatever the node started, in reverse order."""
        if self.api_server:
            self.api_server.close()
        if self.metrics_server:
            self.metrics_server.close()
        if self._slo_engine is not None:
            from ..observability import slo

            slo.uninstall(self._slo_engine)
        from ..state_transition import stf as _stf

        if _stf._METRICS is getattr(self, "metrics", None):
            _stf.set_metrics(None)  # no STF timing goes to a closed node's registry
        if self._trace_hook is not None:
            self.tracer.on_finish[:] = [cb for cb in self.tracer.on_finish
                                        if cb is not self._trace_hook]
        if self.stack is not None:
            self.stack.close()  # lanes, supervisor, device, population thread
        elif self.lanes is not None:
            self.lanes.close()  # the node's lanes; the supervisor is the caller's
        if self.chain is not None:
            self.chain.close()
        if self.db is not None:
            self.db.close()
