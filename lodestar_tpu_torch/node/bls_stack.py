"""The serving stack, composed as the JAX package's `node/node.py` composes
it (`:103-152`) and populated at the epoch transition as its
`_populate_epoch_table_async` (`:405`) does:

    BlsLaneDispatcher            lanes, coalescing, shedding
      SupervisedBlsVerifier      deadline, retry, breaker, audit, eviction
        DeviceBlsVerifier        the port's verdicts on the card
        CpuBlsVerifier           the host tier (fallback and audit)

`build_bls_stack` also installs the SLO engine over the stack's
pipeline, wires the process-wide lifecycle tracer (`observability/
spans.py`) as `node.py:84-100` does: finished traces tick
`lodestar_lifecycle_traces_total{kind}` on the stack's registry (the
stack's hook replaces any an earlier stack left) and the metrics server
serves them at `/debug/traces`. It starts that server when `metrics_port`
is given (0: an ephemeral port), preloads the libraries from the
ahead-of-time store and runs the warm-boot ladder first when `warm=True`
(`compile_ledger.preload_aot`, `warmup.warm_production`), and marks
`verifier_ready` and `serving_ready` on the startup timeline.
`BlsStack.close()` stops every thread, worker process and server it
started and unhooks its trace counter.

Supervisor spans open only under a live trace of the calling thread. The
lane dispatcher carries no trace onto its flush threads (as in the JAX
package), so the coalesced lanes' calls get none; a caller whose request
goes straight to the supervisor (the block lane, 32 sets and more) and
that holds a trace, such as block import's `chain/bls_verify`, gets
`bls/supervised_batch` and the rest under it.

    stack = build_bls_stack(device="cuda", metrics_port=8008)
    stack.populate_epoch_async(epoch, pubkeys)   # at each epoch transition
    ok = stack.verifier.verify_signature_sets(sets, lane="attestation")
    stack.close()
"""

from __future__ import annotations

import logging
import threading
import time

from ..chain.bls_verifier import CpuBlsVerifier, DeviceBlsVerifier
from ..chain.dispatcher import BlsLaneDispatcher
from ..chain.supervisor import SupervisedBlsVerifier
from ..metrics.bls import create_bls_metrics, lifecycle_traces_counter
from ..metrics.registry import MetricsRegistry
from ..observability import compile_ledger, device_ledger, slo, spans
from ..observability.stages import PipelineMetrics

_log = logging.getLogger("node")


class BlsStack:
    """The composed stack: `verifier` (the lane dispatcher, what gossip and
    block import call), `supervisor`, `device`, `cpu`, the `pipeline` and
    `registry` they record into, `prom` (the `metrics/bls.py` families),
    the installed `slo_engine`, the metrics `server` (or None), the
    lifecycle `tracer` with its `lifecycle_traces` counter, and `preload`,
    the ahead-of-time preload's summary (None unless built warm)."""

    def __init__(self, device, supervisor, verifier, cpu, pipeline, registry, prom,
                 slo_engine, faults=None):
        self.device = device
        self.supervisor = supervisor
        self.verifier = verifier
        self.cpu = cpu
        self.pipeline = pipeline
        self.registry = registry
        self.prom = prom
        self.slo_engine = slo_engine
        self.faults = faults
        self.server = None
        self.tracer = spans.tracer
        self.lifecycle_traces = lifecycle_traces_counter(registry)
        self.preload: dict | None = None
        self.ladder: dict | None = None
        self.last_populate: dict | None = None
        self._populate_lock = threading.Lock()
        self._populate_thread: threading.Thread | None = None  # guarded-by: _populate_lock

    # -- epoch transition --------------------------------------------------------

    def populate_epoch_async(self, epoch: int, pubkeys) -> bool:
        """Decompress the epoch's active pubkeys into the device-resident
        epoch table on a daemon thread, at most one population in flight;
        False (and nothing started) while one runs. `last_populate` gets
        its epoch, rows and seconds, or the error."""
        populate = getattr(self.supervisor, "epoch_table_populate", None)
        if not callable(populate):
            return False
        keys = [bytes(k) for k in pubkeys]
        with self._populate_lock:
            if self._populate_thread is not None and self._populate_thread.is_alive():
                return False

            def _run():
                t0 = time.perf_counter()
                try:
                    rows = populate(epoch, keys)
                    self.last_populate = {"epoch": epoch, "rows": rows,
                                          "seconds": time.perf_counter() - t0}
                    _log.info("epoch table populated: epoch %d, %d rows", epoch, rows)
                except Exception as e:
                    self.last_populate = {"epoch": epoch, "error": str(e),
                                          "seconds": time.perf_counter() - t0}
                    _log.warning("epoch-table population failed: %s", e)

            t = threading.Thread(target=_run, name="epoch-table-fill", daemon=True)
            self._populate_thread = t
        t.start()
        return True

    def wait_populated(self, timeout: float | None = None) -> bool:
        """Wait for the population in flight; True when none is left."""
        with self._populate_lock:
            t = self._populate_thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    # -- debug surface -------------------------------------------------------------

    def start_server(self, port: int = 0, host: str = "127.0.0.1"):
        """Serve `/metrics` and `/debug/*` on `host:port` (0: ephemeral)."""
        from ..metrics.server import MetricsServer

        sup = self.supervisor
        self.server = MetricsServer(
            self.registry, host=host, port=port, tracer=self.tracer,
            breaker=sup.breaker_snapshot,
            mesh=sup.mesh_snapshot,
            fleet=sup.fleet_snapshot,
            lanes=self.pipeline.lanes_snapshot,
            slo=self.slo_engine.snapshot,
            device=device_ledger.ledger().snapshot,
            epoch_table=sup.epoch_table_snapshot,
            faults=self.faults,
        )
        self.server.start()
        return self.server

    # -- lifecycle -------------------------------------------------------------

    def _count_trace(self, doc) -> None:
        kind = (doc.get("attrs") or {}).get("kind") or doc["name"]
        self.lifecycle_traces.inc(kind=kind)

    _count_trace._stack_wired = True  # marks the hooks of every stack

    def wire_tracer(self) -> None:
        """Count finished traces on this stack's registry, replacing the
        hook of any stack wired before it (re-init REPLACES, as the JAX
        node's does, so a dead registry stops receiving counts)."""
        self.tracer.on_finish[:] = [
            cb for cb in self.tracer.on_finish if not getattr(cb, "_stack_wired", False)
        ] + [self._count_trace]

    def close(self) -> None:
        """Unhook the trace counter, then stop the lane workers (queued
        waiters get a typed shed), the canary and dispatch threads, the
        population thread, the server, the SLO engine and the mesh's
        worker processes, in that order."""
        self.tracer.on_finish[:] = [cb for cb in self.tracer.on_finish
                                    if cb != self._count_trace]
        self.verifier.close()
        self.supervisor.close()
        self.wait_populated()
        if self.server is not None:
            self.server.close()
            self.server = None
        slo.uninstall(self.slo_engine)
        self.device.close()


def build_bls_stack(device=None, mesh=None, observer=None, faults=None, metrics_port=None,
                    *, metrics_host: str = "127.0.0.1", warm: bool = False, rungs=None,
                    rng=None, grouped_configs=((16, 8), (64, 64)),
                    pk_grouped_configs=((128, 32),), supervisor_args: dict | None = None,
                    dispatcher_args: dict | None = None) -> BlsStack:
    """Compose the serving stack over one `DeviceBlsVerifier`.

    `device` (default the GPU; raises without one), `mesh` (None: one
    card; "auto" or a `BlsMeshDispatcher`), `faults` (the duck-typed fault
    seam of the facade, also shown at `/debug/faults`), `rng`,
    `grouped_configs` and `pk_grouped_configs` go to the facade.
    `observer` is the pipeline every layer records into (default: a new
    `PipelineMetrics` on a new registry). `supervisor_args` and
    `dispatcher_args` override the JAX defaults of
    `SupervisedBlsVerifier` (deadline 120 s, one retry, threshold 3,
    cooldown 30 s, audit on) and `BlsLaneDispatcher` (2 workers,
    coalescing 512, pending cap 4096, lane caps 2048/1024/512).
    `warm=True` preloads the libraries of the ahead-of-time store, each
    kernel launched once (`stack.preload`), and runs the warm-boot ladder
    (`rungs`: a subset of `warmup.RUNGS`) before serving is declared
    ready."""
    timeline = compile_ledger.timeline()
    timeline.mark("node_init")
    pipeline = observer if observer is not None else PipelineMetrics(faults=faults)
    registry = getattr(pipeline, "registry", None) or MetricsRegistry()
    prom = create_bls_metrics(registry)
    dev = DeviceBlsVerifier(device=device, grouped_configs=grouped_configs,
                            pk_grouped_configs=pk_grouped_configs, observer=pipeline,
                            faults=faults, rng=rng, mesh=mesh)
    cpu = CpuBlsVerifier()
    try:
        sup = SupervisedBlsVerifier(dev, cpu, observer=pipeline, **(supervisor_args or {}))
        lanes = BlsLaneDispatcher(sup, prom=prom, pipeline=pipeline, **(dispatcher_args or {}))
    except Exception:
        dev.close()
        raise
    engine = slo.install(pipeline)
    timeline.mark("slo_ready")
    stack = BlsStack(dev, sup, lanes, cpu, pipeline, registry, prom, engine, faults)
    stack.wire_tracer()
    try:
        if warm:
            from ..warmup import warm_production

            stack.preload = compile_ledger.ledger().preload_aot(device=dev.device)
            stack.ladder = warm_production(dev._inner, rungs=rungs)
        timeline.mark("verifier_ready")
        if metrics_port is not None:
            stack.start_server(metrics_port, metrics_host)
    except BaseException:
        stack.close()
        raise
    timeline.mark_serving_ready()
    return stack
