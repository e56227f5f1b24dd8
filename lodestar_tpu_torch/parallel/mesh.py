"""Mesh dispatch: one logical BLS verifier served by several GPUs (the JAX
package's `parallel/mesh.py`).

`parallel/sharded.py` holds the sharded verdicts and `parallel/mesh_pool.py`
the worker processes that run them, one per GPU; this module is the
host-side policy that makes them the serving path:

- device census → serving mesh: the largest power-of-two prefix of the
  healthy chips that divides the 64 constant Miller lanes
  (`mesh_divisor`); 1 healthy chip means "no mesh" and the caller's
  single-device verdicts keep serving. A multi-host census (`hosts=`
  rows) gives a two-level layout, as in the JAX package: a power-of-two
  host count × a uniform power-of-two width per host whose product
  divides 64, served by the two-level twins over a pool of rows (each
  host's combines first; `parallel/sharded.py`),
- a lazy per-(kind, shape, layout) cache of sharded verifiers, each
  bound to the chip set it was built for,
- the failure policy's mesh half: `evict()` removes a sick chip and
  shrinks the serving mesh, `evict_host()` is the same state machine one
  level up (the attached router rebalances its gossip subnets onto the
  surviving hosts), and `readmit()` restores the full census when the
  supervisor's canary passes,
- every transition and dispatch is recorded in the `lodestar_bls_mesh_*`
  and `lodestar_bls_fleet_*` families of the observer, and the duck-typed
  `faults` object (as the JAX package's `testing.faults`) gets
  `on_mesh_dispatch(n)` / `on_fleet_dispatch(hosts)` before each
  sharded dispatch.

Where the JAX dispatcher keeps one compiled executable per layout, the
port keeps one pool of worker processes, and at most one is live,
because each worker holds GPU memory: an eviction or a re-admission that
changes the serving chips stops the old pool, and the next dispatch
starts the new one. `close()` stops it; no worker outlives its
dispatcher.
"""

from __future__ import annotations

import logging
import threading
import time as _time

import torch

from ..observability import device_ledger, trace
from ..observability.compile_ledger import ledger as _compile_ledger
from ..observability.stages import default_pipeline
from .mesh_pool import MeshWorkerError, PoolSlot

logger = logging.getLogger("parallel.mesh")

__all__ = ["CONSTANT_LANES", "NOT_SHARDED", "BlsMeshDispatcher", "auto_mesh", "mesh_divisor"]

# the grouped verdicts split the constant −[2^b]g1 Miller lanes across
# chips: 2·HALF_BITS of them (parallel/verifier); the serving mesh must
# divide this count evenly
CONSTANT_LANES = 64


def mesh_divisor(n_devices: int) -> int:
    """Largest usable mesh size ≤ `n_devices`: the grouped verdicts split
    the 64 constant Miller lanes across chips, so the serving mesh must
    divide 64. 64 is a power of two, so this walks powers of two: 5
    healthy chips serve as a 4-chip mesh, 3 as 2, 1 as none."""
    d = 1
    while d * 2 <= min(n_devices, CONSTANT_LANES) and CONSTANT_LANES % (d * 2) == 0:
        d *= 2
    return d


# returned by dispatch_* when this batch cannot shard (mesh too small,
# rows not divisible): the caller falls through to its single-device
# verdict; distinct from None so a sharded False can't be confused with
# "not handled"
NOT_SHARDED = object()


def _ledger_wrap_submit(v, kind: str, shape, chips, hosts: int = 1) -> None:
    """Route a freshly built sharded verifier's `submit` through the
    compile ledger: the first dispatch of each (kind, shape, chip set) is
    one event (a pool's first call of a shape), so a post-eviction mesh
    shrink records a NEW event. Two-level twins record under
    ``fleet_<kind>`` with the host count in the key. Factory products
    whose `submit` cannot be rebound (test stubs) are left untouched."""
    kernel = f"sharded_{kind}" if hosts <= 1 else f"fleet_{kind}"
    static_key = f"{tuple(shape)}@chips{','.join(str(c) for c in chips)}"
    if hosts > 1:
        static_key += f"@hosts{hosts}"
    try:
        v.submit = _compile_ledger().wrap(v.submit, kernel, static_key=static_key)
    except AttributeError:
        logger.debug("mesh: %s verifier submit not rebindable; compile ledger seam skipped", kind)


class BlsMeshDispatcher:
    """Routes grouped/pk-grouped/bisect batches onto the serving mesh and
    owns the evict/re-admit state machine. Thread-safe: the supervisor's
    failure path and the flush thread may race.

    `devices` are the chips of the census (`cuda:i`; the same device may
    appear twice, as two workers on one card). `verifier_factory(kind,
    devices, axis)` builds a verifier with `submit(...)`; by default the
    `parallel/sharded.py` verifier of `kind` over this dispatcher's pool;
    a dead or hung worker makes the dispatch raise within the pool's
    collective timeout (`mesh_pool.TIMEOUT_S`). `hub` is the fleet's
    `FleetHub` (`parallel/fleet.py`), through which the pool starts the
    workers of rows on other hosts (devices named ``host<rank>/...``)."""

    def __init__(self, devices, axis: str = "dp", observer=None,
                 verifier_factory=None, hosts=None,
                 dcn_axis: str = "dcn", ici_axis: str = "ici",
                 router=None, faults=None, hub=None):
        self.axis = axis
        self.dcn_axis = dcn_axis
        self.ici_axis = ici_axis
        self.observer = observer if observer is not None else default_pipeline()
        self._faults = faults
        self._pools = PoolSlot(hub)
        self._factory = verifier_factory or self._default_factory
        self._devices = list(devices)
        self._lock = threading.Lock()
        # chip ids are indices into the census; eviction order is recorded
        # for /debug/mesh and for "evict the most recent suspect" defaults
        self._healthy: list[int] = list(range(len(self._devices)))
        self._evicted: list[dict] = []
        # host census: rows of chip indices; the default single row is
        # the single-host behavior
        if hosts:
            claimed = [c for row in hosts for c in row]
            if sorted(claimed) != sorted(set(claimed)) or any(
                c not in self._healthy for c in claimed
            ):
                raise ValueError("hosts rows must partition distinct chips")
            self._host_map: list[list[int]] = [list(row) for row in hosts]
        else:
            self._host_map = [list(self._healthy)]
        self._evicted_hosts: list[dict] = []
        self._router = router
        self._verifiers: dict = {}
        self._dispatches = 0
        self._host_dispatches: dict[int, int] = {}
        self._publish()

    def _default_factory(self, kind: str, devices, axis):
        """The sharded verifier of `kind` over this dispatcher's pool: a
        chip list under one axis, per-host rows under (dcn, ici)."""
        from . import sharded

        return sharded.VERIFIERS[kind](devices, axis, pools=self._pools)

    # -- census -------------------------------------------------------------

    def _serving_layout(self) -> list[list[int]]:
        """Per-host rows of the chips actually dispatched to. One row =
        single-level mesh. Multiple rows = a two-level (hosts × chips per
        host) layout: a power-of-two host count, a UNIFORM power-of-two
        per-host width (the minimum across surviving hosts), product
        capped so it divides the 64 constant lanes. Host 0 keeps the
        first row: its chip 0 owns the root tail."""
        return [row for _, row in self._serving_rows()]

    def _serving_rows(self) -> list[tuple[int, list[int]]]:
        """(host rank, serving chips) pairs; see `_serving_layout`."""
        gone = {e["host"] for e in self._evicted_hosts}
        healthy = set(self._healthy)
        rows = []
        for h, row in enumerate(self._host_map):
            if h in gone:
                continue
            hc = [c for c in row if c in healthy]
            if hc:
                rows.append((h, hc))
        if not rows:
            return []
        if len(rows) == 1:
            h, hc = rows[0]
            return [(h, hc[: mesh_divisor(len(hc))])]
        per = mesh_divisor(min(len(hc) for _, hc in rows))
        nh = 1
        while nh * 2 <= len(rows) and nh * 2 * per <= CONSTANT_LANES:
            nh *= 2
        return [(h, hc[:per]) for h, hc in rows[:nh]]

    @property
    def size(self) -> int:
        """Current serving-mesh size (chips actually dispatched to, across
        every serving host)."""
        return sum(len(r) for r in self._serving_layout())

    @property
    def hosts_serving(self) -> int:
        return len(self._serving_layout())

    @property
    def hosts_total(self) -> int:
        return len(self._host_map)

    @property
    def enabled(self) -> bool:
        return self.size >= 2

    def _serving_chips(self) -> list[int]:
        return [c for row in self._serving_layout() for c in row]

    def _publish(self) -> None:
        self.observer.mesh_state(self.size, len(self._evicted))
        if len(self._host_map) > 1:
            self.observer.fleet_state(self.hosts_serving, len(self._evicted_hosts))

    def attach_router(self, router) -> None:
        """Bind the FleetRouter whose subnet slices must follow host
        evictions (node wiring; tests pass router= directly)."""
        self._router = router

    # -- verifier cache -----------------------------------------------------

    def _verifier(self, kind: str, shape):
        with self._lock:
            rows = self._serving_rows()
            chips = tuple(c for _, row in rows for c in row)
            # keyed by the full (host rank, chip set) layout: the same
            # chip set regrouped under different hosts is a different
            # device assignment
            key = (kind, shape, tuple((h, tuple(r)) for h, r in rows))
            v = self._verifiers.get(key)
            if v is None:
                if len(rows) > 1:
                    devs = [[self._devices[c] for c in row] for _, row in rows]
                    ax = (self.dcn_axis, self.ici_axis)
                else:
                    devs = [self._devices[c] for c in chips]
                    ax = self.axis
                v = self._factory(kind, devs, ax)
                _ledger_wrap_submit(v, kind, shape, chips, hosts=len(rows))
                self._verifiers[key] = v
            return v, chips, rows

    # -- dispatch -----------------------------------------------------------

    def _pre_dispatch(self, kind: str, chips, rows) -> None:
        if self._faults is not None:
            self._faults.on_mesh_dispatch(len(chips))
            if len(rows) > 1:
                self._faults.on_fleet_dispatch([h for h, _ in rows])
        with self._lock:
            self._dispatches += 1
            if len(rows) > 1:
                for h, _ in rows:
                    self._host_dispatches[h] = self._host_dispatches.get(h, 0) + 1
        self.observer.mesh_dispatch(chips)
        if len(rows) > 1:
            self.observer.fleet_dispatch([h for h, _ in rows])

    def _submit_timed(self, rows, fn):
        """Run one verifier submit; dispatches that span hosts are
        wall-timed into the fleet DCN-seconds counter (an upper bound on
        the cross-host collective cost)."""
        if len(rows) <= 1:
            return fn()
        t0 = _time.monotonic()
        try:
            return fn()
        finally:
            self.observer.fleet_dcn_seconds(_time.monotonic() - t0)

    def _dispatch(self, kind: str, shape, *args):
        v, chips, rows = self._verifier(kind, shape)
        self._pre_dispatch(kind, chips, rows)
        with trace.annotation(f"bls/mesh/{kind}[{len(chips)}]"), \
                device_ledger.ledger().dispatch(kind, chips):
            try:
                return self._submit_timed(rows, lambda: v.submit(*args))
            except MeshWorkerError as e:
                # the pool's worker and row indices → this census
                e.chip = chips[e.chip]
                if e.host is not None:
                    e.host = rows[e.host][0]
                raise

    def dispatch_grouped(self, g, a_bits, b_bits):
        """Sharded root-grouped dispatch; NOT_SHARDED when ineligible."""
        n = self.size
        if n < 2 or g.pk_x.shape[0] % n:
            return NOT_SHARDED
        return self._dispatch("grouped", g.pk_x.shape[:2], g, a_bits, b_bits)

    def dispatch_grouped_raw(self, g, sig_raw, a_bits, b_bits):
        """Sharded root-grouped RAW dispatch (wire-byte signatures,
        decompressed by each worker); NOT_SHARDED when ineligible."""
        n = self.size
        if n < 2 or g.pk_x.shape[0] % n:
            return NOT_SHARDED
        return self._dispatch("grouped_raw", g.pk_x.shape[:2], g, sig_raw, a_bits, b_bits)

    def dispatch_pk_grouped(self, g, a_bits, b_bits):
        """Sharded pk-grouped dispatch; NOT_SHARDED when ineligible."""
        n = self.size
        if n < 2 or g.msg_x.shape[0] % n:
            return NOT_SHARDED
        return self._dispatch("pk_grouped", g.msg_x.shape[:2], g, a_bits, b_bits)

    def dispatch_pk_grouped_raw(self, g, sig_raw, a_bits, b_bits):
        """Sharded pk-grouped RAW dispatch; NOT_SHARDED when ineligible."""
        n = self.size
        if n < 2 or g.msg_x.shape[0] % n:
            return NOT_SHARDED
        return self._dispatch("pk_grouped_raw", g.msg_x.shape[:2], g, sig_raw, a_bits, b_bits)

    def dispatch_bisect(self, arrs, r_bits):
        """Sharded bisection-tree dispatch; NOT_SHARDED when ineligible
        (the sharded tree needs a power-of-two batch the host already
        padded: other buckets stay on the single-device tree)."""
        n = self.size
        lanes = arrs.pk_x.shape[0]
        if n < 2 or lanes % n or lanes & (lanes - 1):
            return NOT_SHARDED
        return self._dispatch("bisect", (lanes,), arrs, r_bits)

    # -- failure policy -----------------------------------------------------

    def _stop_pool_if_moved(self, serving_before) -> None:
        """Stop the live pool when the serving chips changed: the next
        dispatch starts the pool of the new chip set."""
        if self._serving_chips() != serving_before:
            self._pools.close()

    def evict(self, chip: int | None = None, reason: str = "failure"):
        """Remove a sick chip from the census and shrink the serving mesh.
        Returns the NEW serving size, or None when nothing was evicted
        (no mesh / last healthy chip)."""
        with self._lock:
            if len(self._healthy) <= 1:
                return None
            before = self._serving_chips()
            if chip is None or chip not in self._healthy:
                # no attribution: drop the highest-index healthy chip (the
                # serving prefix keeps chip 0, the root-tail owner, stable)
                chip = self._healthy[-1]
            self._healthy.remove(chip)
            self._evicted.append({"chip": chip, "reason": reason})
            new_size = self.size
        self._stop_pool_if_moved(before)
        self.observer.mesh_eviction(chip, reason)
        self._publish()
        logger.warning(
            "mesh: evicted chip %d (%s): serving continues on %d chip(s)",
            chip, reason, max(new_size, 1),
        )
        return new_size

    def evict_host(self, host: int | None = None, reason: str = "failure"):
        """The chip-eviction state machine one level up: remove a whole
        HOST from the serving census, rebalance its gossip subnets onto
        the survivors (via the attached router) and keep serving on the
        smaller layout. Returns the NEW total serving size, or None when
        nothing was evicted (single-host census / last serving host)."""
        with self._lock:
            gone = {e["host"] for e in self._evicted_hosts}
            active = [h for h in range(len(self._host_map)) if h not in gone]
            if len(self._host_map) < 2 or len(active) <= 1:
                return None
            before = self._serving_chips()
            if host is None or host not in active:
                # no attribution: drop the highest-rank active host (host
                # 0, the root-tail owner, stays)
                host = active[-1]
            self._evicted_hosts.append({"host": host, "reason": reason})
            new_size = self.size
            new_hosts = self.hosts_serving
        self._stop_pool_if_moved(before)
        self.observer.fleet_host_eviction(host, reason)
        moved = None
        if self._router is not None:
            try:
                moved = self._router.evict_host(host)
            except Exception:  # pragma: no cover (routing must not mask)
                logger.exception("fleet: router rebalance failed")
        self._publish()
        logger.warning(
            "fleet: evicted host %d (%s): serving continues on %d host(s) / %d chip(s)%s",
            host, reason, max(new_hosts, 1), max(new_size, 1),
            f", {moved} subnet(s) rebalanced" if moved is not None else "",
        )
        return new_size

    def readmit(self) -> int:
        """Restore every evicted chip AND host to the census (canary
        passed). Returns the number of census entries re-admitted."""
        with self._lock:
            n = len(self._evicted)
            nh = len(self._evicted_hosts)
            if not n and not nh:
                return 0
            before = self._serving_chips()
            self._healthy = list(range(len(self._devices)))
            self._evicted = []
            self._evicted_hosts = []
        self._stop_pool_if_moved(before)
        if n:
            self.observer.mesh_readmission(n)
        if self._router is not None and nh:
            try:
                self._router.readmit_hosts()
            except Exception:  # pragma: no cover
                logger.exception("fleet: router readmit failed")
        self._publish()
        logger.info(
            "mesh: re-admitted %d chip(s) + %d host(s): serving mesh back to %d",
            n, nh, self.size,
        )
        return n + nh

    def has_evicted(self) -> bool:
        return bool(self._evicted or self._evicted_hosts)

    def close(self) -> None:
        """Stop the live pool (its processes are joined, or killed after a
        grace period). A later dispatch starts a new one."""
        self._pools.close()

    @property
    def pool(self):
        """The live worker pool, or None (none started yet, or stopped)."""
        return self._pools.pool

    def start_pool(self):
        """Start the pool of the serving layout now rather than at the
        first dispatch (a warm-up; `pool.start_seconds` times it): one row
        of chips, or one row per serving host; returns it."""
        if not self.enabled:
            return None
        with self._lock:
            rows = [[self._devices[c] for c in row] for row in self._serving_layout()]
        return self._pools.acquire(rows if len(rows) > 1 else rows[0])

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "devices_total": len(self._devices),
                "healthy": list(self._healthy),
                "serving": self._serving_chips(),
                "size": self.size,
                "evicted": [dict(e) for e in self._evicted],
                "dispatches": self._dispatches,
                "compiled": sorted(
                    f"{k[0]}:{'x'.join(str(d) for d in k[1])}"
                    f"@{sum(len(r) for _, r in k[2])}"
                    + (f"/{len(k[2])}hosts" if len(k[2]) > 1 else "")
                    for k in self._verifiers
                ),
            }
            if len(self._host_map) > 1:
                snap["fleet"] = self._fleet_fields_locked()
            return snap

    def _fleet_fields_locked(self) -> dict:
        rows = self._serving_rows()
        return {
            "hosts_total": len(self._host_map),
            "hosts_serving": len(rows),
            "layout": {str(h): list(r) for h, r in rows},
            "evicted_hosts": [dict(e) for e in self._evicted_hosts],
            "host_dispatches": {str(h): n for h, n in sorted(self._host_dispatches.items())},
        }

    def fleet_snapshot(self) -> dict | None:
        """Host-level census for `/debug/fleet`; None on a single-host
        census."""
        with self._lock:
            if len(self._host_map) <= 1:
                return None
            doc = self._fleet_fields_locked()
        if self._router is not None:
            try:
                doc["router"] = self._router.snapshot()
            except Exception as e:  # pragma: no cover (census must not fail)
                logger.debug(f"fleet router snapshot failed: {e}")
        return doc


def auto_mesh(observer=None, device=None, faults=None, fleet=None):
    """The mesh policy at verifier construction: the JAX package's
    LODESTAR_TPU_MESH default, `auto`, hard-coded. A dispatcher over every
    visible CUDA device when more than one is visible and the verifier
    runs on CUDA; None otherwise (the CPU never meshes unless a
    dispatcher is passed in; one card serves single-device).

    `fleet` (a `FleetTopology`, default None: exactly the above) that is
    active groups the census into per-host rows (`group_devices`): in
    emulation this host's cards split into virtual hosts; in a
    distributed fleet, after the rendezvous (`ensure_initialized`), the
    census is this host's cards and every joined agent's, and the
    dispatcher starts those through the fleet's hub. Never raises: a
    verifier must construct even when device enumeration or the
    rendezvous fails (it then serves single-host)."""
    try:
        if device is None or torch.device(device).type != "cuda":
            return None
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        hosts, hub = None, None
        if fleet is not None and fleet.active:
            if fleet.mode == "distributed" and fleet.ensure_initialized():
                hub = fleet.hub
                devices += hub.devices()
            hosts = fleet.group_devices(devices)
        if len(devices) < 2:
            return None
        dispatcher = BlsMeshDispatcher(devices, observer=observer, faults=faults, hosts=hosts,
                                       hub=hub)
        if not dispatcher.enabled:
            return None
        logger.info("mesh serving enabled: %d cuda device(s), serving size %d across %d "
                    "host(s)", len(devices), dispatcher.size, dispatcher.hosts_serving)
        return dispatcher
    except Exception as e:  # pragma: no cover (environment-dependent)
        logger.warning("mesh auto-detect failed (%s); serving unsharded", e)
        return None
