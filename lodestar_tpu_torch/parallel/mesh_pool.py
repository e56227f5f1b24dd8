"""The worker processes of a mesh: one per GPU, joined by a gloo process
group (the PyTorch counterpart of the JAX package's `jax.sharding.Mesh`).

The verdicts are bound by host dispatch (hundreds of thousands of small
PyTorch operations per batch), so one Python thread enqueuing every
card's slice would multiply the host's work by the mesh size. Instead
each serving chip gets a process of its own that dispatches its own
slice, and only the partials cross between processes:

- The serving process is the controller. It sends each worker its row
  slice of a batch's host arrays and receives the verdict. It runs no
  shard and is not a member of the process group: headers, row slices
  and replies travel over one `multiprocessing.connection.Connection`
  per worker, so an idle worker blocks on it (no timeout) and a dead one
  shows as a closed connection at once.
- A pool is rows of devices, one row per host (a flat list is one row;
  every row as wide as the first). A row of this host's devices is
  started by the controller with the `spawn` context (CUDA does not
  survive `fork`) as daemons, each on a pipe. A row of another host's
  devices (`fleet.remote_device` names) is started by that host's agent
  (`parallel/fleet_host.py`) at the request of the fleet's hub
  (`fleet.FleetHub`); its workers dial back to the hub over TCP with the
  fleet's authkey.
- Worker k pins its device (`cuda:i` on the card, `cpu` in the tests; a
  CUDA device that is missing raises, nothing falls back to the CPU) and
  joins the workers' gloo group: `file://` rendezvous in a temporary
  directory of the pool and the loopback interface when every worker is
  local; else `tcp://` at a free port of the coordinator's host, over the
  interface that reaches it. A collective times out after `TIMEOUT_S`,
  60 s. Worker k is host k // per's worker k % per (DCN-major, as the JAX
  `_mesh_index`), and a two-level pool also makes each host's group and
  each chip position's cross-host group (`sharded.Shard.join`). It then
  loops: receive a request, run the sharded verdict of its kind
  (`parallel/sharded.py`), which takes part in the workers'
  collectives, and reply. Worker 0 runs the tail and replies the verdict.
- The collectives carry host tensors: a worker copies its partial to the
  host before a gather and uploads what it gathered. They are small: one
  Fp12 (1.5 KiB) and 64 projective G2 plane sums (48 KiB) per worker, or
  per host across hosts.

A dead or hung worker makes the dispatch raise `MeshWorkerError` and
leaves the pool broken: every later dispatch raises too, until the
caller's supervisor evicts the chip or the host and the dispatcher
replaces the pool. Its `chip` is a worker's index and its `host` a row's
(or None), which the dispatcher maps to its census: the worker that
raised or died; where a worker's collective failed (`CollectiveError`: a
peer hung or died inside it), the first worker that has not replied once
the others have had `timeout_s / 4` more to reply, so that the hung card
is the one evicted, not a healthy peer. Where every worker of a host is
down (dead, its agent gone) or silent, the error names that host, so
that the supervisor evicts the host and not one chip.
A `counts` request returns each worker's kernel launch counts (and may
zero them): instrumentation for the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import fcntl
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import shutil
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import torch

from ..observability import trace
from .fleet import remote_device, split_device

__all__ = ["TIMEOUT_S", "CollectiveError", "MeshPool", "MeshWorkerError", "PoolSlot",
           "launch_counts"]

TIMEOUT_S = 60.0  # the workers' collective timeout
START_TIMEOUT_S = 300.0  # spawn, import torch, initialise the device, rendezvous
REPLY_TIMEOUT_S = 1800.0  # a verdict's compute (a cold worker builds its kernels)
GRACE_S = 5.0  # a stopping worker's time to exit before it is killed
HOST_GRACE_S = 1.0  # after one worker's death, the time its host's others have to show theirs


class MeshWorkerError(RuntimeError):
    """A worker of the pool died, hung or raised. `chip` is the worker's
    index in the pool and `host` its row's where every worker of that
    row is down or silent (else None), until the dispatcher maps them to
    its census."""

    def __init__(self, chip: int, message: str, host: int | None = None):
        where = f"mesh worker {chip}" if host is None else f"mesh host {host} (worker {chip})"
        super().__init__(f"{where}: {message}")
        self.chip = chip
        self.host = host


class CollectiveError(RuntimeError):
    """A collective of the workers' group failed on this worker: a peer
    hung (the collective timed out) or died (its connection closed)."""


def _device_name(device) -> str:
    rank, dev = split_device(device)
    name = str(torch.device(dev))
    return name if rank is None else remote_device(rank, name)


def _layout(devices) -> tuple[tuple[str, ...], ...]:
    """Rows of normalised device names; a flat list is one row."""
    devices = list(devices)
    rows = devices if devices and isinstance(devices[0], (list, tuple)) else [devices]
    return tuple(tuple(_device_name(d) for d in row) for row in rows)


def launch_counts(reset: bool = False) -> dict:
    """This process's kernel launch counts (K1, K4, K2, K2p, K3, K3-fe);
    with `reset`, zeroed after they are read."""
    from ..ops import cuda_fp, cuda_mxu, cuda_tower

    counts = {"K1": cuda_fp.LAUNCHES, "K4": cuda_mxu.LAUNCHES,
              "K2": cuda_tower.MILLER_LAUNCHES, "K2p": cuda_tower.MILLER_PROJ_LAUNCHES,
              "K3": cuda_tower.PAIRING_LAUNCHES, "K3-fe": cuda_tower.FINAL_EXP_LAUNCHES}
    if reset:
        cuda_fp.LAUNCHES = cuda_mxu.LAUNCHES = 0
        cuda_tower.MILLER_LAUNCHES = cuda_tower.MILLER_PROJ_LAUNCHES = 0
        cuda_tower.PAIRING_LAUNCHES = cuda_tower.FINAL_EXP_LAUNCHES = 0
    return counts


def _free_port(host: str) -> int:
    """A TCP port of `host` that is free now (the gloo store binds it)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _interface_to(host: str) -> str | None:
    """The name of this machine's interface whose address routes to
    `host` (a UDP connect sends nothing), or None when none matches."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, 9))
        ip = s.getsockname()[0]
        for _, name in socket.if_nameindex():
            try:  # SIOCGIFADDR: the interface's IPv4 address
                req = fcntl.ioctl(s.fileno(), 0x8915, struct.pack("256s", name.encode()[:15]))
            except OSError:
                continue
            if socket.inet_ntoa(req[20:24]) == ip:
                return name
    return None


def _serve(shard, msg):
    """One request of the controller, on this worker."""
    op = msg[0]
    if op == "run":
        from . import sharded

        return sharded.run_shard(msg[1], shard, msg[2])
    if op == "counts":
        return launch_counts(reset=msg[1])
    if op == "modules":
        return sorted(sys.modules)
    if op == "place":
        return shard.index, shard.host, shard.local
    raise ValueError(f"unknown request {op!r}")


def _worker_main(index: int, size: int, hosts: int, init_method: str, device: str,
                 timeout_s: float, conn, coordinator: str | None = None):
    """A worker's process: pin the device, join the group, serve.
    `coordinator` is the host of a distributed pool's rendezvous (None:
    every worker is local, the group stays on the loopback interface)."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # raises without the card
        else:
            torch.set_num_threads(1)  # several workers share the host's cores
        ifname = "lo" if coordinator is None else _interface_to(coordinator)
        if ifname is not None:
            os.environ.setdefault("GLOO_SOCKET_IFNAME", ifname)
        timeout = timedelta(seconds=timeout_s)
        dist.init_process_group("gloo", init_method=init_method, rank=index, world_size=size,
                                timeout=timeout)
        from .sharded import Shard

        shard = Shard.join(index, size, hosts, dev, timeout)
        from ..observability import compile_ledger

        # the libraries from the store and each kernel's first launch, paid
        # before the first verdict (an evicted chip's replacement included)
        preload = compile_ledger.ledger().preload_aot(device=dev)
        conn.send(("ready", {"pid": os.getpid(), "preload": preload}))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return  # the controller is gone
            if msg[0] == "stop":
                return
            try:
                conn.send(("ok", _serve(shard, msg)))
            except CollectiveError:
                conn.send(("collective", traceback.format_exc()))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        try:
            dist.destroy_process_group()
        except Exception:
            pass


def _exit_with_parent() -> None:
    mp.parent_process().join()
    os._exit(1)


def _remote_worker_main(address, authkey: bytes, pool_id: str, index: int, size: int,
                        hosts: int, init_method: str, device: str, timeout_s: float):
    """A worker started by a host agent: it exits with its agent, dials
    the hub at `address` with the fleet's authkey, names itself and
    serves as `_worker_main` over that connection."""
    threading.Thread(target=_exit_with_parent, name="exit-with-agent", daemon=True).start()
    conn = mp_connection.Client(tuple(address), authkey=authkey)
    conn.send(("worker", pool_id, index, os.getpid()))
    _worker_main(index, size, hosts, init_method, device, timeout_s, conn,
                 coordinator=address[0])


class MeshPool:
    """One worker process per device of `devices` (rows of devices, one
    per host; a flat list is one row), started at construction
    (`start_seconds` says how long that took). `hub` is the fleet's
    `FleetHub`, needed when a row lies on another host. `run(kind,
    arrays)` splits every array by rows (axis 0) into equal slices, one
    per worker in DCN-major order, and returns every worker's reply in
    worker order; `counts(reset)` each worker's launch counts; `close()`
    stops the workers. `timeout_s` is the workers' collective timeout.
    Each worker preloads the libraries of the ahead-of-time store before
    it reports ready (`compile_ledger.preload_aot`: each library's store
    outcome, each kernel launched once on a card); `preload` holds their
    summaries in worker order."""

    timeout_s = TIMEOUT_S

    def __init__(self, devices, hub=None):
        self.layout = _layout(devices)
        self.hosts = len(self.layout)
        self.per = len(self.layout[0])
        if not self.per or any(len(row) != self.per for row in self.layout):
            raise ValueError(f"pool rows must be non-empty and equally wide: {self.layout}")
        self.devices = tuple(d for row in self.layout for d in row)
        self.size = len(self.devices)
        # each row's agent rank, None for a row of this host's devices
        self._ranks = []
        for row in self.layout:
            ranks = {split_device(d)[0] for d in row}
            if len(ranks) != 1:
                raise ValueError(f"a pool row spans hosts: {row}")
            self._ranks.append(ranks.pop())
        remote = any(r is not None for r in self._ranks)
        if remote and hub is None:
            raise ValueError("a pool row on another host needs the fleet's hub")
        self._hub = hub
        self._pool_id = hub.new_pool_id() if remote else None
        self.closed = False
        self._broken: tuple[int, str, int | None] | None = None
        self._lock = threading.Lock()  # one request at a time
        self._procs: list = [None] * self.size  # None: the worker of an agent
        self._conns: list = [None] * self.size
        t0 = time.monotonic()
        self._dir = tempfile.mkdtemp(prefix="lodestar-mesh-")
        coordinator = hub.address[0] if remote else None
        init = (f"tcp://{coordinator}:{_free_port(coordinator)}" if remote
                else f"file://{os.path.join(self._dir, 'rendezvous')}")
        ctx = mp.get_context("spawn")
        try:
            for h, rank in enumerate(self._ranks):
                if rank is not None:
                    self._start_remote(h, init)
                    continue
                for k in self._workers_of(h):
                    parent, child = ctx.Pipe()
                    proc = ctx.Process(target=_worker_main, name=f"bls-mesh-{k}", daemon=True,
                                       args=(k, self.size, self.hosts, init, self.devices[k],
                                             self.timeout_s, child, coordinator))
                    proc.start()
                    child.close()  # the worker's end: a dead worker shows as EOF here
                    self._procs[k] = proc
                    self._conns[k] = parent
            for h, rank in enumerate(self._ranks):
                if rank is not None:
                    try:
                        conns = self._hub.take_workers(rank, self._pool_id, self._workers_of(h),
                                                       START_TIMEOUT_S)
                    except (ConnectionError, TimeoutError) as e:
                        raise self._fail(h * self.per, str(e), host=h) from e
                    for k, conn in conns.items():
                        self._conns[k] = conn
            ready = self._collect(START_TIMEOUT_S)
            self.pids = [r["pid"] for r in ready]
            self.preload = [r["preload"] for r in ready]
        except BaseException:
            self.close()
            raise
        self.start_seconds = time.monotonic() - t0

    def _workers_of(self, h: int) -> list[int]:
        return list(range(h * self.per, (h + 1) * self.per))

    def _start_remote(self, h: int, init: str) -> None:
        """Ask row h's agent for its workers; an agent that is gone or
        refuses makes the start raise, naming the host."""
        spec = {"workers": [(k, split_device(self.devices[k])[1]) for k in self._workers_of(h)],
                "size": self.size, "hosts": self.hosts, "init": init,
                "timeout_s": self.timeout_s}
        try:
            self._hub.start_workers(self._ranks[h], self._pool_id, spec)
        except (ConnectionError, TimeoutError) as e:
            raise self._fail(h * self.per, f"its agent did not start workers: {e}",
                             host=h) from e

    def _fail(self, k: int, message: str, host: int | None = None):
        self._broken = (k, message, host)
        return MeshWorkerError(k, message, host)

    def _worker_alive(self, k: int) -> bool:
        proc = self._procs[k]
        if proc is not None:
            return proc.is_alive()
        return self._hub.agent_alive(self._ranks[k // self.per])

    def _host_down(self, h: int, wait_s: float) -> bool:
        """Every worker of host h is dead (its agent gone, for another
        host's row), within `wait_s`."""
        deadline = time.monotonic() + wait_s
        while any(self._worker_alive(k) for k in self._workers_of(h)):
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        return True

    def _down(self, k: int, message: str):
        """The error of worker k's death: its host's, when every worker
        of that host is down too (two-level pools only)."""
        h = k // self.per
        if self.hosts > 1 and self._host_down(h, HOST_GRACE_S):
            return self._fail(h * self.per, f"every worker of the host is down; worker {k}: "
                                            f"{message}", host=h)
        return self._fail(k, message)

    def _check_usable(self) -> None:
        if self.closed:
            raise RuntimeError("mesh pool is closed")
        if self._broken is not None:
            raise MeshWorkerError(*self._broken)
        for k in range(self.size):
            if not self._worker_alive(k):
                proc = self._procs[k]
                raise self._down(k, f"worker on {self.devices[k]} exited" + (
                    "" if proc is None else f" with code {proc.exitcode}"))

    def _collect(self, timeout_s: float) -> list:
        """Every worker's reply, in worker order. An error or a closed
        connection raises at once, blaming its worker (or its host, when
        the host's other workers are down too). A failed collective waits
        up to `timeout_s / 4` for the other replies, then blames the first
        worker that has not replied, or else the first whose collective
        failed; the deadline blames the first worker that has not
        replied. Where every worker of a host is silent and some other
        worker replied, the host is blamed."""
        pending = {conn: k for k, conn in enumerate(self._conns)}
        out: list = [None] * self.size
        deadline = time.monotonic() + timeout_s
        failed: tuple[int, str] | None = None  # the first failed collective
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            for conn in mp_connection.wait(list(pending), timeout=left):
                k = pending.pop(conn)
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    if self._procs[k] is not None:
                        self._procs[k].join(1.0)
                        raise self._down(k, f"worker on {self.devices[k]} died (exit code "
                                            f"{self._procs[k].exitcode})")
                    raise self._down(k, f"worker on {self.devices[k]} closed its connection")
                if status == "error":
                    raise self._fail(k, value)
                if status == "collective" and failed is None:
                    failed = (k, value)
                    deadline = min(deadline, time.monotonic() + self.timeout_s / 4)
                out[k] = value
        if pending:
            silent = set(pending.values())
            why = (f"no reply within {timeout_s:.0f} s" if failed is None else
                   f"no reply; worker {failed[0]}'s collective failed:\n{failed[1]}")
            if self.hosts > 1 and len(silent) < self.size:
                for h in range(self.hosts):
                    if silent.issuperset(self._workers_of(h)):
                        raise self._fail(h * self.per, f"every worker of the host is silent: "
                                                       f"{why}", host=h)
            raise self._fail(min(silent), why)
        if failed is not None:
            raise self._fail(*failed)
        return out

    def _request(self, msgs, timeout_s: float) -> list:
        with self._lock:
            self._check_usable()
            for k, (conn, msg) in enumerate(zip(self._conns, msgs)):
                try:
                    conn.send(msg)
                except (BrokenPipeError, EOFError, OSError) as e:
                    raise self._down(k, f"send failed: {e!r}")
            return self._collect(timeout_s)

    def run(self, kind: str, arrays) -> list:
        """Run the sharded verdict `kind` over the row slices of `arrays`;
        returns every worker's reply (worker 0's is the verdict). Worker
        0's host seconds per device stage (it runs its slice and the
        tail) go to the observer the calling thread has bound
        (`trace.observing`: the verifier's)."""
        rows = arrays[0].shape[0]
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split over {self.size} workers")
        per = rows // self.size
        msgs = [("run", kind, tuple(a[k * per:(k + 1) * per] for a in arrays))
                for k in range(self.size)]
        replies = self._request(msgs, REPLY_TIMEOUT_S)
        for label, seconds in replies[0][1].items():
            trace.observe_stage(label, seconds)
        return [reply for reply, _ in replies]

    def counts(self, reset: bool = False) -> list[dict]:
        """Each worker's launch counts (`launch_counts`), zeroed after the
        read with `reset`."""
        return self._request([("counts", reset)] * self.size, self.timeout_s)

    def modules(self) -> list[list[str]]:
        """The modules each worker has imported."""
        return self._request([("modules",)] * self.size, self.timeout_s)

    def places(self) -> list[tuple[int, int, int]]:
        """Each worker's (index, host, index within the host)."""
        return self._request([("place",)] * self.size, self.timeout_s)

    def alive(self) -> list[bool]:
        return [self._worker_alive(k) for k in range(self.size)]

    def kill(self, k: int) -> None:
        """Kill worker k and wait for it (the eviction drill's sick chip);
        a worker of another host's agent is stopped with its agent."""
        if self._procs[k] is None:
            raise ValueError(f"worker {k} runs on another host: stop its agent")
        self._procs[k].kill()
        self._procs[k].join(GRACE_S)

    def close(self) -> None:
        """Stop the workers: ask each to exit, join them, and kill those
        still running after `GRACE_S` (another host's agent does so for
        its workers)."""
        if self.closed:
            return
        self.closed = True
        for conn in self._conns:
            try:
                if conn is not None:
                    conn.send(("stop",))
            except (BrokenPipeError, EOFError, OSError):
                pass
        for rank in {r for r in self._ranks if r is not None}:
            self._hub.stop_workers(rank, self._pool_id)
        if self._pool_id is not None:
            self._hub.drop_pool(self._pool_id)
        procs = [p for p in self._procs if p is not None]
        deadline = time.monotonic() + GRACE_S
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(GRACE_S)
        for conn in self._conns:
            if conn is not None:
                conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)


class PoolSlot:
    """Holds at most one live `MeshPool`: `acquire(devices)` returns the
    live pool of that layout, starting it when there is none or when the
    live one serves another layout (which is stopped first). A broken
    pool is returned as it is (its dispatches raise) until `close()`.
    `hub` is the fleet's, for rows on other hosts."""

    def __init__(self, hub=None):
        self._pool: MeshPool | None = None
        self._hub = hub
        self._lock = threading.Lock()

    @property
    def pool(self) -> MeshPool | None:
        return self._pool

    def acquire(self, devices) -> MeshPool:
        layout = _layout(devices)
        with self._lock:
            if self._pool is not None and (self._pool.closed or self._pool.layout != layout):
                self._pool.close()
                self._pool = None
            if self._pool is None:
                self._pool = MeshPool(layout, self._hub)
            return self._pool

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()
