"""The host agent of a distributed fleet: run on every host but the
controller's, it starts and stops that host's mesh workers at the
controller's request.

    python3 -m lodestar_tpu_torch.parallel.fleet_host --coordinator HOST:PORT \
        --rank R --devices cuda:0,cuda:1 --authkey-file F

The agent dials the controller's hub (`parallel/fleet.py::FleetHub`) at
the coordinator address with the fleet's authkey (the file's bytes,
which every host of the fleet holds; a key that differs is refused),
retrying until the hub listens, and reports its rank and devices. Then
it serves: each new pool asks it to start workers (`spawn`ed, each
running `mesh_pool._remote_worker_main`, which dials the hub back) and
to stop them, so that one agent outlives many pools. When the
controller's connection closes, the agent stops its workers and exits
(code 0); when the agent dies, its workers exit with it, and the
controller's next dispatch raises, naming this host.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
import sys
import time
import traceback
from multiprocessing.connection import Client

from .fleet import JOIN_TIMEOUT_S, parse_coordinator, read_authkey
from .mesh_pool import GRACE_S, _remote_worker_main

logger = logging.getLogger("parallel.fleet_host")


def connect(address, authkey: bytes, timeout_s: float = JOIN_TIMEOUT_S):
    """A connection to the hub at `address`, retried while it refuses (it
    may not listen yet) until `timeout_s`; a wrong key raises at once."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return Client(tuple(address), authkey=authkey)
        except ConnectionRefusedError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.25)


def _stop(procs) -> None:
    deadline = time.monotonic() + GRACE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(GRACE_S)


def serve(conn, address, authkey: bytes) -> None:
    """Answer the controller's start and stop requests on `conn` until it
    closes; then stop every worker."""
    ctx = mp.get_context("spawn")
    pools: dict[str, list] = {}
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return  # the controller is gone
            op, pool_id = msg[0], msg[1]
            if op == "start":
                spec = msg[2]
                try:
                    # registered first: the controller's stop of a failed start
                    # reaches the workers already started
                    procs = pools[pool_id] = []
                    for k, device in spec["workers"]:
                        p = ctx.Process(target=_remote_worker_main, name=f"bls-mesh-{k}",
                                        daemon=True,
                                        args=(address, authkey, pool_id, k, spec["size"],
                                              spec["hosts"], spec["init"], device,
                                              spec["timeout_s"]))
                        p.start()
                        procs.append(p)
                    conn.send(("started", pool_id, [p.pid for p in procs]))
                except Exception:
                    conn.send(("error", pool_id, traceback.format_exc()))
            elif op == "stop":
                _stop(pools.pop(pool_id, []))
                conn.send(("stopped", pool_id, None))
            else:
                conn.send(("error", pool_id, f"unknown request {op!r}"))
    finally:
        _stop([p for procs in pools.values() for p in procs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lodestar_tpu_torch.parallel.fleet_host",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", required=True, help="the controller's hub, HOST:PORT")
    ap.add_argument("--rank", type=int, required=True, help="this host's rank, 1 or more")
    ap.add_argument("--devices", required=True, help="this host's worker devices, e.g. "
                                                     "cuda:0,cuda:1")
    ap.add_argument("--authkey-file", required=True, help="the file holding the fleet's key")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    address = parse_coordinator(args.coordinator)
    authkey = read_authkey(args.authkey_file)
    devices = [d.strip() for d in args.devices.split(",") if d.strip()]
    conn = connect(address, authkey)
    conn.send(("join", args.rank, devices, os.getpid()))
    logger.info("joined %s as rank %d with %s", args.coordinator, args.rank, devices)
    try:
        serve(conn, address, authkey)
    finally:
        conn.close()
    logger.info("the controller closed the connection; stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
