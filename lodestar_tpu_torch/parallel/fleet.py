"""Fleet topology, subnet routing and the controller's rendezvous: the
host-level (DCN) tier above the worker pool (the JAX package's
`parallel/fleet.py`).

- `FleetTopology` answers "how many hosts, which rank am I, and how do
  the devices group into hosts". Where the JAX class reads the
  ``LODESTAR_TPU_FLEET*`` knobs, the port reads none: `parse(spec,
  hosts, rank)` takes the same three values as arguments, with the same
  rules, and the default is "off". Two modes: "distributed" (the spec
  names the coordinator's ``host:port``; the other hosts run the
  `fleet_host` agent, which joins the controller there) and "emulate"
  (the local devices split into `hosts` virtual hosts).
- `FleetRouter` owns the subnet → host-rank assignment for attestation
  gossip: rendezvous (highest-random-weight) hashing over the active
  hosts, so that evicting a host moves only that host's subnets.
- `FleetHub` is the controller's end of a distributed fleet, which the
  JAX package gets from `jax.distributed`: a TCP listener at the
  coordinator address that host agents join (each reports its rank and
  devices) and that the workers they start dial back to. Every peer
  passes the `multiprocessing.connection` HMAC challenge with the
  fleet's authkey, both ways, before a byte of it is unpickled; there is
  no unauthenticated mode.

A device of another host is named ``host<rank>/<device>``
(`remote_device`), so that a census lists every worker's place in one
list of strings; a plain device name is a device of this host.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from multiprocessing import AuthenticationError
from multiprocessing.connection import Listener, answer_challenge, deliver_challenge

logger = logging.getLogger("parallel.fleet")

__all__ = ["ATTESTATION_SUBNET_COUNT", "FleetHub", "FleetRouter", "FleetTopology",
           "parse_coordinator", "read_authkey", "remote_device", "split_device"]

ATTESTATION_SUBNET_COUNT = 64  # the JAX package's params/constants.py
JOIN_TIMEOUT_S = 300.0  # every agent's join (an agent retries until the hub listens)
HANDSHAKE_TIMEOUT_S = 10.0  # a peer's challenge and first message
REPLY_TIMEOUT_S = 60.0  # an agent's reply to a start or stop request

_OFF = ("", "0", "off", "false", "none")


def remote_device(rank: int, device: str) -> str:
    """The census name of `device` on host `rank`."""
    return f"host{rank}/{device}"


def split_device(name: str) -> tuple[int | None, str]:
    """(host rank, device) of a census name; the rank is None for a
    device of this host."""
    head, sep, device = str(name).partition("/")
    if sep and head.startswith("host") and head[4:].isdigit():
        return int(head[4:]), device
    return None, str(name)


def read_authkey(path: str) -> bytes:
    """The fleet's authkey: the bytes of the file at `path`, surrounding
    whitespace stripped. An empty key is refused."""
    with open(path, "rb") as f:
        key = f.read().strip()
    if not key:
        raise ValueError(f"fleet: the authkey file {path} is empty")
    return key


def parse_coordinator(coordinator: str) -> tuple[str, int]:
    """(host, port) of a "host:port" coordinator address."""
    host, _, port = coordinator.rpartition(":")
    return host or "127.0.0.1", int(port)


@dataclass
class FleetTopology:
    """A resolved fleet configuration.

    mode:         "off" | "emulate" | "distributed"
    coordinator:  "host:port" of the controller's hub (distributed only)
    hosts:        fleet host count (agents + the controller's host, or
                  virtual hosts)
    rank:         this process's host rank in [0, hosts)
    authkey_file: the file holding the fleet's authkey (distributed only;
                  the hub refuses to listen without one)
    """

    mode: str = "off"
    coordinator: str | None = None
    hosts: int = 1
    rank: int = 0
    authkey_file: str | None = None
    hub: FleetHub | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def active(self) -> bool:
        return self.mode != "off" and self.hosts > 1

    @classmethod
    def parse(cls, spec, hosts=None, rank=None, authkey_file=None) -> FleetTopology:
        """The JAX `from_env` rules over arguments: `spec` empty, "0",
        "off", "false" or "none" gives off; a rank outside [0, hosts)
        gives off, with a warning; a spec containing ":" names the
        coordinator ("distributed"); anything else gives "emulate".
        `hosts` defaults to 2 and `rank` to 0. Never raises on the values."""
        spec = (spec or "").strip()
        if spec.lower() in _OFF:
            return cls()
        hosts = max(int(hosts or 2), 1)
        rank = int(rank or 0)
        if not 0 <= rank < hosts:
            logger.warning("fleet: rank %d outside [0, %d); fleet disabled", rank, hosts)
            return cls()
        if ":" in spec:
            return cls(mode="distributed", coordinator=spec, hosts=hosts, rank=rank,
                       authkey_file=authkey_file)
        return cls(mode="emulate", coordinator=None, hosts=hosts, rank=rank)

    def ensure_initialized(self, timeout_s: float = JOIN_TIMEOUT_S) -> bool:
        """The fleet's rendezvous (idempotent; emulation needs none). On
        rank 0 of a distributed fleet: start the hub at the coordinator
        address and wait until every other host's agent has joined.
        Returns True when that is done, False on failure, with a warning
        (the caller serves single-host). Ranks above 0 run the
        `fleet_host` agent, not a verifier: False."""
        if self.mode != "distributed":
            return True
        if self.rank != 0:
            logger.warning("fleet: rank %d runs `python3 -m lodestar_tpu_torch.parallel."
                           "fleet_host`, not a verifier; serving single-host", self.rank)
            return False
        try:
            if self.hub is None:
                if not self.authkey_file:
                    raise ValueError("no authkey file: the hub does not listen unauthenticated")
                self.hub = FleetHub(parse_coordinator(self.coordinator),
                                    read_authkey(self.authkey_file), self.hosts)
            if not self.hub.wait_agents(timeout_s):
                raise TimeoutError(f"agents of ranks {self.hub.missing()} did not join "
                                   f"within {timeout_s:.0f} s")
            logger.info("fleet: %d host agent(s) joined at %s", self.hosts - 1, self.coordinator)
            return True
        except (OSError, ValueError, TimeoutError) as e:
            logger.warning("fleet: rendezvous at %s failed (%s); serving single-host",
                           self.coordinator, e)
            return False

    def group_devices(self, devices) -> list[list[int]] | None:
        """Group a census (device names) into per-host rows of device
        INDICES. Distributed mode groups by the host rank in each name
        (`split_device`; a plain name is host 0), in rank order;
        emulation splits the devices into `hosts` equal contiguous rows.
        None when no multi-host grouping exists (serve single-level)."""
        if not self.active:
            return None
        if self.mode == "distributed":
            by_rank: dict[int, list[int]] = {}
            for i, d in enumerate(devices):
                by_rank.setdefault(split_device(d)[0] or 0, []).append(i)
            rows = [by_rank[r] for r in sorted(by_rank)]
        else:
            per = len(devices) // self.hosts
            if per < 1:
                return None
            rows = [list(range(h * per, (h + 1) * per)) for h in range(self.hosts)]
        return rows if len(rows) > 1 else None


class FleetRouter:
    """Subnet → host-rank assignment via rendezvous (HRW) hashing.

    Every host computes the same owner for every subnet (sha256 of
    ``subnet:host``, highest weight wins over the ACTIVE hosts), so the
    fleet agrees on the partition without traffic: slices are disjoint
    and cover every subnet. Thread-safe: the supervisor's eviction path
    and the gossip validators race on the active set."""

    def __init__(self, hosts: int, rank: int = 0, subnet_count: int = ATTESTATION_SUBNET_COUNT,
                 observer=None):
        if hosts < 1:
            raise ValueError(f"fleet needs >= 1 host, got {hosts}")
        if not 0 <= rank < hosts:
            raise ValueError(f"rank {rank} outside [0, {hosts})")
        self.hosts = hosts
        self.rank = rank
        self.subnet_count = subnet_count
        self.observer = observer
        self._lock = threading.Lock()
        self._evicted: list[int] = []
        self._rebalances = 0
        self._subnets_moved = 0
        self._foreign_dropped = 0

    # -- assignment ---------------------------------------------------------

    @staticmethod
    def _weight(subnet: int, host: int) -> int:
        digest = hashlib.sha256(b"lodestar-fleet-subnet:%d:host:%d" % (subnet, host)).digest()
        return int.from_bytes(digest[:8], "big")

    def active_hosts(self) -> list[int]:
        with self._lock:
            return [h for h in range(self.hosts) if h not in self._evicted]

    def owner(self, subnet: int) -> int:
        """The host rank that owns `subnet` under the current active set."""
        active = self.active_hosts()
        if not active:
            raise RuntimeError("fleet router has no active hosts")
        return max(active, key=lambda h: self._weight(subnet, h))

    def owns(self, subnet: int) -> bool:
        return self.owner(subnet) == self.rank

    def slice_for(self, rank: int | None = None) -> tuple[int, ...]:
        """Every subnet owned by `rank` (default: this host)."""
        r = self.rank if rank is None else rank
        return tuple(s for s in range(self.subnet_count) if self.owner(s) == r)

    # -- host eviction / rebalance ------------------------------------------

    def evict_host(self, rank: int) -> int | None:
        """Drop a host from the active set and rebalance its subnets onto
        the survivors (only the evicted host's subnets move). Returns the
        number of subnets that moved, or None when the eviction is a
        no-op (unknown or already evicted rank, last host)."""
        with self._lock:
            active = [h for h in range(self.hosts) if h not in self._evicted]
            if rank not in active or len(active) <= 1:
                return None
            before = {s: max(active, key=lambda h: self._weight(s, h))
                      for s in range(self.subnet_count)}
            self._evicted.append(rank)
            survivors = [h for h in active if h != rank]
            moved = sum(1 for s in range(self.subnet_count)
                        if before[s] != max(survivors, key=lambda h: self._weight(s, h)))
            self._rebalances += 1
            self._subnets_moved += moved
        if self.observer is not None:
            self.observer.fleet_rebalance(moved)
        logger.warning("fleet: host %d evicted from subnet routing: %d subnet(s) rebalanced "
                       "onto %d surviving host(s)", rank, moved, len(survivors))
        return moved

    def readmit_hosts(self) -> int:
        """Restore every evicted host to the routing table (canary
        passed). Returns the number of hosts re-admitted."""
        with self._lock:
            n = len(self._evicted)
            if not n:
                return 0
            self._evicted = []
            self._rebalances += 1
        if self.observer is not None:
            self.observer.fleet_rebalance(0)
        logger.info("fleet: %d host(s) re-admitted to subnet routing", n)
        return n

    def record_foreign(self, subnet: int) -> None:
        """Count an attestation seen for a subnet this host does NOT own
        (gossip overlap, dropped before validation)."""
        with self._lock:
            self._foreign_dropped += 1

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            evicted = list(self._evicted)
            rebalances = self._rebalances
            moved = self._subnets_moved
            foreign = self._foreign_dropped
        owned = self.slice_for()
        return {
            "hosts": self.hosts,
            "rank": self.rank,
            "active_hosts": self.active_hosts(),
            "evicted_hosts": evicted,
            "subnet_count": self.subnet_count,
            "owned_subnets": list(owned),
            "owned": len(owned),
            "rebalances": rebalances,
            "subnets_moved": moved,
            "foreign_dropped": foreign,
        }


# --- the controller's hub ------------------------------------------------------


def _set_recv_timeout(conn, seconds: float) -> None:
    """Bound each blocking read of `conn`'s socket (0: unbounded), so
    that a peer that connects and stays silent cannot hold a handshake."""
    s = socket.fromfd(conn.fileno(), socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                     struct.pack("ll", int(seconds), int(seconds % 1 * 1e6)))
    finally:
        s.close()


class _Agent:
    def __init__(self, rank: int, conn, devices):
        self.rank = rank
        self.conn = conn
        self.devices = list(devices)
        self.lock = threading.Lock()  # one request at a time
        self.alive = True


class FleetHub:
    """The controller's TCP listener at `address` ((host, port); port 0
    takes a free one, `address` then says which). Host agents join it
    (`fleet_host`): each reports its rank in [1, `hosts`) and its devices
    and then starts and stops workers at the controller's request. The
    workers an agent starts dial back here and are handed to the pool
    that asked for them (`take_workers`). A peer that fails the authkey
    challenge, or is silent for `HANDSHAKE_TIMEOUT_S`, is dropped and
    counted in `refused`. `close()` stops listening and drops every
    agent (each agent then stops its workers and exits)."""

    def __init__(self, address, authkey: bytes, hosts: int):
        if not authkey:
            raise ValueError("fleet: the hub does not listen without an authkey")
        self.hosts = int(hosts)
        self._authkey = bytes(authkey)
        # authentication is done per connection, in a handshake thread
        self._listener = Listener(tuple(address), backlog=64)
        self.address = self._listener.address
        self._cv = threading.Condition()
        self._agents: dict[int, _Agent] = {}
        self._workers: dict[tuple[str, int], object] = {}
        self._pool_ids = itertools.count()
        self.refused = 0
        self.closed = False
        threading.Thread(target=self._accept_loop, name="fleet-hub", daemon=True).start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn = self._listener.accept()
            except OSError:
                if self.closed:
                    return
                logger.exception("fleet: accept failed")
                continue
            if self.closed:  # the wake-up of `close()`
                conn.close()
                return
            threading.Thread(target=self._handshake, args=(conn,), name="fleet-handshake",
                             daemon=True).start()

    def _handshake(self, conn) -> None:
        try:
            _set_recv_timeout(conn, HANDSHAKE_TIMEOUT_S)
            deliver_challenge(conn, self._authkey)
            answer_challenge(conn, self._authkey)
            hello = conn.recv()
            _set_recv_timeout(conn, 0)
            self._admit(conn, hello)
        except (AuthenticationError, EOFError, OSError, TypeError, ValueError) as e:
            conn.close()
            with self._cv:
                self.refused += 1
            logger.warning("fleet: refused a connection: %s", e)

    def _admit(self, conn, hello) -> None:
        kind = hello[0] if isinstance(hello, tuple) and hello else None
        with self._cv:
            if self.closed:
                raise ValueError("the hub is closed")
            if kind == "join":
                _, rank, devices, pid = hello
                if not 1 <= rank < self.hosts:
                    raise ValueError(f"an agent of rank {rank} joined a fleet of {self.hosts}")
                if self.agent_alive(rank):
                    raise ValueError(f"an agent of rank {rank} is already joined")
                self._agents[rank] = _Agent(rank, conn, devices)
                logger.info("fleet: agent of rank %d (pid %d) joined with %s", rank, pid, devices)
            elif kind == "worker":
                _, pool_id, index, _pid = hello
                self._workers[(pool_id, index)] = conn
            else:
                raise ValueError(f"unknown hello {kind!r}")
            self._cv.notify_all()

    # -- agents ---------------------------------------------------------------

    @staticmethod
    def _agent_alive_locked(agent: _Agent) -> bool:
        """An idle agent sends nothing: its connection is readable only
        once it has closed. The caller holds `agent.lock`."""
        if agent.alive and agent.conn.poll(0):
            try:
                msg = agent.conn.recv()
                logger.warning("fleet: agent %d sent %r unasked", agent.rank, msg)
            except (EOFError, OSError):
                agent.alive = False
                agent.conn.close()
        return agent.alive

    def agent_alive(self, rank: int) -> bool:
        agent = self._agents.get(rank)
        if agent is None:
            return False
        with agent.lock:
            return self._agent_alive_locked(agent)

    def missing(self) -> list[int]:
        """The ranks whose agent has not joined, or has gone."""
        return [r for r in range(1, self.hosts) if not self.agent_alive(r)]

    def wait_agents(self, timeout_s: float) -> bool:
        """Wait until an agent of every rank in [1, hosts) is joined."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self.missing():
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.5))
        return True

    def devices(self) -> list[str]:
        """Every joined agent's devices as census names, in rank order."""
        with self._cv:
            agents = sorted(self._agents.items())
        return [remote_device(r, d) for r, a in agents if self.agent_alive(r) for d in a.devices]

    def _request(self, rank: int, msg, timeout_s: float):
        agent = self._agents.get(rank)
        if agent is None:
            raise ConnectionError(f"no agent of rank {rank} has joined")
        with agent.lock:
            if not self._agent_alive_locked(agent):
                raise ConnectionError(f"the agent of rank {rank} has gone")
            try:
                agent.conn.send(msg)
                if not agent.conn.poll(timeout_s):
                    raise TimeoutError(f"the agent of rank {rank} did not reply within "
                                       f"{timeout_s:.0f} s")
                return agent.conn.recv()
            except (EOFError, OSError) as e:
                agent.alive = False
                raise ConnectionError(f"the agent of rank {rank} has gone ({e!r})") from e

    def new_pool_id(self) -> str:
        return f"{id(self):x}-{next(self._pool_ids)}"

    def start_workers(self, rank: int, pool_id: str, spec: dict) -> list[int]:
        """Ask the agent of `rank` to start the workers of `spec`
        (`mesh_pool._remote_worker_main`'s arguments); returns their pids."""
        status, _, pids = self._request(rank, ("start", pool_id, spec), REPLY_TIMEOUT_S)
        if status != "started":
            raise ConnectionError(f"the agent of rank {rank} could not start workers: {pids}")
        return pids

    def stop_workers(self, rank: int, pool_id: str) -> None:
        """Ask the agent of `rank` to stop the workers of `pool_id` (joined,
        or killed after a grace period); nothing when it has gone."""
        try:
            self._request(rank, ("stop", pool_id), REPLY_TIMEOUT_S)
        except (ConnectionError, TimeoutError) as e:
            logger.warning("fleet: stopping pool %s on rank %d: %s", pool_id, rank, e)

    def take_workers(self, rank: int, pool_id: str, indices, timeout_s: float) -> dict:
        """The connections of the workers `indices` of `pool_id`, which the
        agent of `rank` started, once each has dialled back;
        ConnectionError when that agent goes first, TimeoutError naming
        the workers that did not dial back in time."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                missing = [k for k in indices if (pool_id, k) not in self._workers]
                if not missing:
                    return {k: self._workers.pop((pool_id, k)) for k in indices}
                if not self.agent_alive(rank):
                    raise ConnectionError(f"the agent of rank {rank} has gone")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"workers {missing} did not dial back within "
                                       f"{timeout_s:.0f} s")
                self._cv.wait(min(left, 0.5))

    def drop_pool(self, pool_id: str) -> None:
        """Close the connections of `pool_id`'s workers that dialled back
        after their pool stopped waiting."""
        with self._cv:
            for key in [key for key in self._workers if key[0] == pool_id]:
                self._workers.pop(key).close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:  # a thread blocked in accept() does not return when its socket closes
            socket.create_connection(self.address, timeout=1).close()
        except OSError:
            pass
        self._listener.close()
        with self._cv:
            agents, self._agents = list(self._agents.values()), {}
            workers, self._workers = list(self._workers.values()), {}
        for c in [a.conn for a in agents] + workers:
            c.close()
