"""The worker processes of a mesh: one per GPU, joined by a gloo process
group (the PyTorch counterpart of the JAX package's `jax.sharding.Mesh`).

The verdicts are bound by host dispatch (hundreds of thousands of small
PyTorch operations per batch), so one Python thread enqueuing every
card's slice would multiply the host's work by the mesh size. Instead
each serving chip gets a process of its own that dispatches its own
slice, and only the partials cross between processes:

- The serving process is the controller. It starts the workers with the
  `spawn` context (CUDA does not survive `fork`) as daemons, sends each
  its row slice of a batch's host arrays and receives the verdict. It
  runs no shard and is not a member of the process group: headers, row
  slices and replies travel over one pipe per worker, so an idle worker
  blocks on its pipe (no timeout) and a dead one shows as a closed pipe
  at once.
- Worker k pins `devices[k]` (`cuda:i` on the card, `cpu` in the tests;
  a CUDA device that is missing raises, nothing falls back to the CPU)
  and joins the workers' gloo group (`file://` rendezvous in a temporary
  directory of the pool, a collective timeout of `TIMEOUT_S`, 60 s).
  It then loops: receive a request, run the sharded verdict of its kind
  (`parallel/sharded.py`), which takes part in the workers' collectives,
  and reply. The first worker runs the tail and replies the verdict.
- The collectives carry host tensors: a worker copies its partial to the
  host before a gather and uploads what it gathered. They are small: one
  Fp12 (1.5 KiB) and 64 projective G2 plane sums (48 KiB) per worker.

A dead or hung worker makes the dispatch raise `MeshWorkerError` and
leaves the pool broken: every later dispatch raises too, until the
caller's supervisor evicts the chip and the dispatcher replaces the pool.
Its `chip` is a worker's index, which the dispatcher maps to its census:
the worker that raised or died; where a worker's collective failed
(`CollectiveError`: a peer hung or died inside it), the first worker that
has not replied once the others have had `timeout_s / 4` more to reply,
so that the hung card is the one evicted, not a healthy peer.
A `counts` request returns each worker's kernel launch counts (and may
zero them): instrumentation for the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import torch

__all__ = ["TIMEOUT_S", "CollectiveError", "MeshPool", "MeshWorkerError", "PoolSlot",
           "launch_counts"]

TIMEOUT_S = 60.0  # the workers' collective timeout
START_TIMEOUT_S = 300.0  # spawn, import torch, initialise the device, rendezvous
REPLY_TIMEOUT_S = 1800.0  # a verdict's compute (a cold worker builds its kernels)
GRACE_S = 5.0  # a stopping worker's time to exit before it is killed


class MeshWorkerError(RuntimeError):
    """A worker of the pool died, hung or raised. `chip` is the worker's
    index in the pool until the dispatcher maps it to its census."""

    def __init__(self, chip: int, message: str):
        super().__init__(f"mesh worker {chip}: {message}")
        self.chip = chip


class CollectiveError(RuntimeError):
    """A collective of the workers' group failed on this worker: a peer
    hung (the collective timed out) or died (its connection closed)."""


def _device_name(device) -> str:
    return str(torch.device(device))


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
    raise ValueError(f"unknown request {op!r}")


def _worker_main(index: int, size: int, init_file: str, device: str, timeout_s: float, conn):
    """A worker's process: pin the device, join the group, serve."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # raises without the card
        else:
            torch.set_num_threads(1)  # several workers share the host's cores
        # the group's traffic stays on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=index,
                                world_size=size, timeout=timedelta(seconds=timeout_s))
        from .sharded import Shard

        shard = Shard(index, size, dist.group.WORLD, dev)
        conn.send(("ready", os.getpid()))
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


class MeshPool:
    """One worker process per entry of `devices`, started at construction
    (`start_seconds` says how long that took). `run(kind, arrays)` splits
    every array by rows (axis 0) into equal slices, one per worker, and
    returns every worker's reply in worker order; `counts(reset)` each
    worker's launch counts; `close()` stops the workers. `timeout_s` is
    the workers' collective timeout."""

    timeout_s = TIMEOUT_S

    def __init__(self, devices):
        self.devices = tuple(_device_name(d) for d in devices)
        self.size = len(self.devices)
        self.closed = False
        self._broken: tuple[int, str] | None = None
        self._lock = threading.Lock()  # one request at a time
        self._procs: list = []
        self._conns: list = []
        t0 = time.monotonic()
        self._dir = tempfile.mkdtemp(prefix="lodestar-mesh-")
        init_file = os.path.join(self._dir, "rendezvous")
        ctx = mp.get_context("spawn")
        try:
            for k, dev in enumerate(self.devices):
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=_worker_main, name=f"bls-mesh-{k}", daemon=True,
                                   args=(k, self.size, init_file, dev, self.timeout_s, child))
                proc.start()
                child.close()  # the worker's end: a dead worker shows as EOF here
                self._procs.append(proc)
                self._conns.append(parent)
            self.pids = self._collect(START_TIMEOUT_S)
        except BaseException:
            self.close()
            raise
        self.start_seconds = time.monotonic() - t0

    def _fail(self, k: int, message: str):
        self._broken = (k, message)
        return MeshWorkerError(k, message)

    def _check_usable(self) -> None:
        if self.closed:
            raise RuntimeError("mesh pool is closed")
        if self._broken is not None:
            raise MeshWorkerError(*self._broken)
        for k, proc in enumerate(self._procs):
            if not proc.is_alive():
                raise self._fail(k, f"worker on {self.devices[k]} exited with code {proc.exitcode}")

    def _collect(self, timeout_s: float) -> list:
        """Every worker's reply, in worker order. An error or a closed pipe
        raises at once, blaming its worker. A failed collective waits up to
        `timeout_s / 4` for the other replies, then blames the first worker
        that has not replied, or else the first whose collective failed;
        the deadline blames the first worker that has not replied."""
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
                    self._procs[k].join(1.0)
                    raise self._fail(k, f"worker on {self.devices[k]} died "
                                        f"(exit code {self._procs[k].exitcode})")
                if status == "error":
                    raise self._fail(k, value)
                if status == "collective" and failed is None:
                    failed = (k, value)
                    deadline = min(deadline, time.monotonic() + self.timeout_s / 4)
                out[k] = value
        if pending:
            why = (f"no reply within {timeout_s:.0f} s" if failed is None else
                   f"no reply; worker {failed[0]}'s collective failed:\n{failed[1]}")
            raise self._fail(min(pending.values()), why)
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
                    raise self._fail(k, f"send failed: {e!r}")
            return self._collect(timeout_s)

    def run(self, kind: str, arrays) -> list:
        """Run the sharded verdict `kind` over the row slices of `arrays`;
        returns every worker's reply (the first worker's is the verdict)."""
        rows = arrays[0].shape[0]
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split over {self.size} workers")
        per = rows // self.size
        msgs = [("run", kind, tuple(a[k * per:(k + 1) * per] for a in arrays))
                for k in range(self.size)]
        return self._request(msgs, REPLY_TIMEOUT_S)

    def counts(self, reset: bool = False) -> list[dict]:
        """Each worker's launch counts (`launch_counts`), zeroed after the
        read with `reset`."""
        return self._request([("counts", reset)] * self.size, self.timeout_s)

    def modules(self) -> list[list[str]]:
        """The modules each worker has imported."""
        return self._request([("modules",)] * self.size, self.timeout_s)

    def alive(self) -> list[bool]:
        return [p.is_alive() for p in self._procs]

    def kill(self, k: int) -> None:
        """Kill worker k and wait for it (the eviction drill's sick chip)."""
        self._procs[k].kill()
        self._procs[k].join(GRACE_S)

    def close(self) -> None:
        """Stop the workers: ask each to exit, join them, and kill those
        still running after `GRACE_S`."""
        if self.closed:
            return
        self.closed = True
        for conn in self._conns:
            try:
                conn.send(("stop",))
            except (BrokenPipeError, EOFError, OSError):
                pass
        deadline = time.monotonic() + GRACE_S
        for proc in self._procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
                proc.join(GRACE_S)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)


class PoolSlot:
    """Holds at most one live `MeshPool`: `acquire(devices)` returns the
    live pool of that chip set, starting it when there is none or when the
    live one serves another set (which is stopped first). A broken pool
    is returned as it is (its dispatches raise) until `close()`."""

    def __init__(self):
        self._pool: MeshPool | None = None
        self._lock = threading.Lock()

    @property
    def pool(self) -> MeshPool | None:
        return self._pool

    def acquire(self, devices) -> MeshPool:
        names = tuple(_device_name(d) for d in devices)
        with self._lock:
            if self._pool is not None and (self._pool.closed or self._pool.devices != names):
                self._pool.close()
                self._pool = None
            if self._pool is None:
                self._pool = MeshPool(names)
            return self._pool

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()
