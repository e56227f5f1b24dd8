"""`beacon` command: run a beacon node.

Reference: `cli/src/cmds/beacon/handler.ts:25` — config from flags, db at
the datadir, anchor state via the checkpoint-sync / db-resume / genesis
decision tree (`initBeaconState.ts`), then `BeaconNode.init` and a clock
loop until interrupted.

The port's copy of the JAX package's `cli/beacon.py`. `--device` (default
`cuda`) takes the place of `--tpu-verifier`: the node's serving stack runs
on that device, and `--device cpu` runs it on the kernels' plain versions
on a machine without a card. Where the JAX CLI falls back from the native
KV engine to `FileDb`, this one does too, and logs it and counts it in
`lodestar_db_native_kv_fallbacks_total` on `/metrics`.
"""

from __future__ import annotations

import os
import signal
import time

from ..config.beacon_config import BeaconConfig, ChainForkConfig
from ..config.chain_config import MAINNET_CHAIN_CONFIG, MINIMAL_CHAIN_CONFIG
from ..db import BeaconDb
from ..db.controller import FileDb, MemoryDb
from ..params.presets import MAINNET, MINIMAL
from ..state_transition import interop_genesis_state
from ..types import get_types
from ..utils.logger import get_logger

KV_FALLBACK = ("lodestar_db_native_kv_fallbacks_total",
               "datadirs opened with FileDb because the native KV engine failed")


def _read_token_file(path: str | None) -> str | None:
    """Bearer token from a file (reference: api/rest bearer-auth token file);
    whitespace-stripped, None when unset. A missing or empty file is a
    configuration error — refusing loudly beats serving with a
    zero-entropy token or rejecting every client."""
    if not path:
        return None
    try:
        with open(path) as f:
            token = f.read().strip()
    except OSError as e:
        raise SystemExit(f"--rest-auth-token-file: cannot read {path}: {e}")
    if not token:
        raise SystemExit(f"--rest-auth-token-file: {path} is empty")
    return token


def _fetch_checkpoint_state(url: str) -> tuple[str, bytes]:
    """(fork_name, ssz_bytes) of a finalized state over the debug SSZ route
    (reference: fetchWeakSubjectivityState from --checkpointSyncUrl)."""
    from urllib.parse import urlparse

    from ..api.client import BeaconApiClient

    parsed = urlparse(url if "//" in url else f"http://{url}")
    client = BeaconApiClient(parsed.hostname, parsed.port or 5052)
    data = client.getStateV2("finalized")
    return data["version"], bytes.fromhex(data["ssz"].removeprefix("0x"))


def open_datadir(datadir: str | None, log=None):
    """The db controller for `datadir`: the legacy single-file and the
    `chain.db` layouts keep `FileDb`; otherwise the native KV engine at `<datadir>/kv`.
    Returns (controller, fell_back): `fell_back` is True when the engine
    failed to open and `FileDb` at `<datadir>/chain.db` took its place."""
    log = log or get_logger("beacon")
    if not datadir:
        return MemoryDb(), False
    if os.path.isfile(datadir):
        # legacy layout: --datadir pointed straight at the db log file
        log.info("using legacy single-file datadir layout")
        return FileDb(datadir), False
    if os.path.isfile(os.path.join(datadir, "chain.db")):
        # a FileDb datadir (the Python log format): keep reading it
        log.info("using the FileDb datadir layout")
        return FileDb(os.path.join(datadir, "chain.db")), False
    os.makedirs(datadir, exist_ok=True)
    try:
        from ..db.controller import NativeKvDb

        controller = NativeKvDb(os.path.join(datadir, "kv"))
        log.info("native KV engine at %s/kv", datadir)
        return controller, False
    except (RuntimeError, OSError) as e:
        log.warning("native KV unavailable (%s); FileDb fallback", e)
        return FileDb(os.path.join(datadir, "chain.db")), True


def run_beacon(args) -> int:
    # the node (and with it PyTorch) only for this command: `validator`
    # shares the dispatcher and does no device work
    from ..node import BeaconNode, NodeOptions, init_beacon_state

    log = get_logger("beacon")
    if args.network == "minimal-dev":
        preset, chain_config = MINIMAL, MINIMAL_CHAIN_CONFIG
    else:
        preset, chain_config = MAINNET, MAINNET_CHAIN_CONFIG
    types_all = get_types(preset)
    fork_config = ChainForkConfig(chain_config, preset)

    # anchor decision tree
    checkpoint_bytes = None
    checkpoint_fork = "phase0"
    genesis_state = None
    if args.checkpoint_sync_url:
        log.info("checkpoint sync from %s", args.checkpoint_sync_url)
        checkpoint_fork, checkpoint_bytes = _fetch_checkpoint_state(
            args.checkpoint_sync_url
        )
    db_controller, kv_fell_back = open_datadir(args.datadir, log)
    probe_db = BeaconDb(types_all.phase0, db_controller)
    if checkpoint_bytes is None and args.genesis_validators:
        genesis_state = interop_genesis_state(
            fork_config,
            types_all.phase0,
            args.genesis_validators,
            genesis_time=args.genesis_time or int(time.time()),
        )
    state, origin = init_beacon_state(
        fork_config,
        types_all,
        probe_db,
        checkpoint_state_bytes=checkpoint_bytes,
        checkpoint_fork=checkpoint_fork,
        genesis_state=genesis_state,
    )
    from ..node.init_state import _fork_of_state

    types = types_all.by_fork[_fork_of_state(state)]
    config = BeaconConfig(chain_config, bytes(state.genesis_validators_root), preset)
    log.info("anchor: %s (slot %d)", origin, state.slot)

    engine = None
    if args.execution == "mock":
        from ..execution.engine import ExecutionEngineMock

        engine = ExecutionEngineMock()
    elif args.execution:
        from ..execution.engine import ExecutionEngineHttp

        host, _, port = args.execution.rpartition(":")
        secret = bytes.fromhex(args.jwt_secret) if args.jwt_secret else b"\x00" * 32
        engine = ExecutionEngineHttp(host or "127.0.0.1", int(port), secret)

    eth1_provider = None
    if args.eth1_endpoint:
        from ..eth1.provider import Eth1ProviderHttp

        e1_host, _, e1_port = args.eth1_endpoint.rpartition(":")
        eth1_provider = Eth1ProviderHttp(
            config,
            types,
            e1_host or "127.0.0.1",
            int(e1_port),
            deploy_block=args.eth1_deploy_block,
        )
        log.info("eth1 deposit follower: %s", args.eth1_endpoint)

    node = BeaconNode.init(
        config,
        types,
        state,
        NodeOptions(
            db_controller=db_controller,  # datadir-backed, persists restarts
            rest=args.rest,
            rest_port=args.rest_port,
            rest_bearer_token=_read_token_file(args.rest_auth_token_file),
            rest_cors_origin=args.rest_cors,
            metrics=args.metrics,
            metrics_port=args.metrics_port,
            device=args.device,
            execution_engine=engine,
            eth1_provider=eth1_provider,
        ),
    )
    name, help_ = KV_FALLBACK
    node.metrics.registry.counter(name, help_).inc(1 if kv_fell_back else 0)

    stop = {"flag": False}

    def _sigint(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, _sigint)

    # irrecoverable fork-choice faults force an orderly exit (reference
    # ProcessShutdownCallback wired in cmds/beacon/handler.ts:43-46)
    def _process_shutdown(reason: str) -> None:
        log.critical("process shutdown requested: %s", reason)
        stop["flag"] = True

    node.chain.process_shutdown_callback = _process_shutdown

    if args.port:
        return _run_networked(args, node, config, types, stop, log)

    clock = _SlotClock(node, state.genesis_time, config.SECONDS_PER_SLOT, args.run_seconds)
    try:
        while not stop["flag"] and not clock.expired():
            clock.tick()
            time.sleep(clock.nap())
        return 0
    finally:
        node.close()
        _log_stopped(log)


def _log_stopped(log) -> None:
    """The last line: the state is persisted, and the kernels this process
    launched (K1, K4, K2, K2p, K3, K3-fe) since the node was ready (the node
    sets the counts to 0 past its preload), which shows where its verdicts
    ran."""
    import json

    from ..parallel.mesh_pool import launch_counts

    log.info("node stopped; state persisted; kernel launches %s", json.dumps(launch_counts()))


class _SlotClock:
    """Wall-clock slot follower shared by the plain and networked loops."""

    def __init__(self, node, genesis_time: int, seconds_per_slot: int, run_seconds: float):
        self.node = node
        self.genesis_time = genesis_time
        self.spt = seconds_per_slot
        self.deadline = time.time() + run_seconds if run_seconds else None
        self.last_slot = -1

    def expired(self) -> bool:
        return self.deadline is not None and time.time() >= self.deadline

    def current_slot(self) -> int:
        return max(0, int(time.time() - self.genesis_time) // self.spt)

    def tick(self) -> int | None:
        """Advance the node if a new slot started; returns it (else None)."""
        slot = self.current_slot()
        if slot == self.last_slot:
            return None
        self.node.on_clock_slot(slot)
        self.last_slot = slot
        return slot

    def nap(self) -> float:
        return min(0.2, self.spt / 10)


def _run_networked(args, node, config, types, stop, log) -> int:
    """Live-networked node: gossip + discovery + reqresp + range sync
    (reference beacon handler with network.start, §3.1)."""
    import asyncio

    from ..network.discovery import enr_from_text, enr_to_text
    from ..network.network import Network

    async def main() -> int:
        bootnodes = []
        for text in (args.bootnodes or "").split(","):
            text = text.strip()
            if text:
                bootnodes.append(enr_from_text(text))
        network = Network(
            config, types, node.chain,
            identity=_load_identity(args.datadir),
            metrics=node.metrics,
        )
        await network.start(
            host=args.listen_address,
            port=args.port if args.port > 0 else 0,
            discovery=True,
            bootnodes=bootnodes,
            advertise_ip=args.advertise_ip,
        )
        node.attach_network(network)
        # merge persisted peers from the last run into the table (reference:
        # libp2p datastore persistence, network/peers/datastore.ts)
        _load_peerstore(args.datadir, network)
        enr_text = enr_to_text(network.discovery.local_enr)
        log.info("p2p listening on %s, peer id %s", network.transport.listen_addr, network.peer_id[:16])
        log.info("ENR: %s", enr_text)
        if args.datadir and os.path.isdir(args.datadir):
            with open(os.path.join(args.datadir, "enr.txt"), "w") as f:
                f.write(enr_text + "\n")

        clock = _SlotClock(
            node, node.chain.head_state.state.genesis_time,
            config.SECONDS_PER_SLOT, args.run_seconds,
        )
        loop = asyncio.get_running_loop()
        sync_state = {"task": None}
        try:
            while not stop["flag"] and not clock.expired():
                slot = clock.tick()
                if slot is not None and (
                    sync_state["task"] is None or sync_state["task"].done()
                ):
                    # background task: the clock must keep ticking and SIGINT
                    # must stay responsive while a long catch-up sync runs
                    sync_state["task"] = loop.create_task(
                        _maybe_range_sync(node, network, slot, loop, log)
                    )
                await asyncio.sleep(clock.nap())
            return 0
        finally:
            _save_peerstore(args.datadir, network)
            await network.stop()
            node.close()
            _log_stopped(log)

    return asyncio.run(main())


def _peerstore_path(datadir):
    if not datadir or not os.path.isdir(datadir):
        return None
    return os.path.join(datadir, "peerstore.txt")


def _save_peerstore(datadir, network) -> None:
    from ..network.discovery import enr_to_text

    path = _peerstore_path(datadir)
    if path is None or network.discovery is None:
        return
    try:
        with open(path, "w") as f:
            for enr in network.discovery.table.all():
                f.write(enr_to_text(enr) + "\n")
    except OSError:
        pass


def _load_peerstore(datadir, network) -> None:
    from ..network.discovery import enr_from_text

    path = _peerstore_path(datadir)
    if path is None or network.discovery is None or not os.path.exists(path):
        return
    loaded = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    enr = enr_from_text(line)
                except ValueError:
                    continue
                network.discovery._known_keys[enr.node_id] = enr.pubkey
                if network.discovery.table.update(enr):
                    loaded += 1
    except OSError:
        return
    if loaded:
        get_logger("beacon").info("restored %d peers from peerstore", loaded)


def _load_identity(datadir):
    """Persist the p2p identity key under the datadir so the node's peer id
    and ENR survive restarts (reference: ENR + peer-id persistence). The
    file holds the 32-byte Ed25519 private key, as the JAX CLI writes it,
    so a datadir keeps its peer id across the two packages."""
    from ..network.transport import NodeIdentity

    if not datadir:
        return None
    if os.path.isfile(datadir):
        return None  # legacy single-file layout has nowhere to keep it
    path = os.path.join(datadir, "network_key")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return NodeIdentity(f.read())
    identity = NodeIdentity()
    with open(path, "wb") as f:
        f.write(identity.private_key)
    os.chmod(path, 0o600)
    return identity


async def _maybe_range_sync(node, network, clock_slot: int, loop, log) -> None:
    """If the head trails the clock by more than an epoch, range-sync from
    the best-status peer (reference RangeSync trigger)."""
    from ..sync.range_sync import RangeSync

    head_slot = node.chain.head_state.state.slot
    if clock_slot <= head_slot + node.config.preset.SLOTS_PER_EPOCH:
        return
    peers = network.sync_peers(loop)
    if not peers:
        return

    def run_sync() -> int:
        rs = RangeSync(
            node.chain, node.types, node.config.preset.SLOTS_PER_EPOCH,
            metrics=getattr(node, "metrics", None),
        )
        for peer in peers:
            rs.add_peer(peer)
        return rs.sync_to(clock_slot)

    try:
        synced = await loop.run_in_executor(None, run_sync)
        log.info("range sync reached slot %d", synced)
    except Exception as e:
        log.warning("range sync failed: %s", e)


def add_beacon_parser(sub) -> None:
    p = sub.add_parser("beacon", help="run a beacon node")
    p.add_argument("--network", default="minimal-dev", choices=["minimal-dev", "mainnet"])
    p.add_argument("--datadir", default=None, help="persistent db path (default: memory)")
    p.add_argument("--checkpoint-sync-url", default=None, help="trusted Beacon API for weak-subjectivity anchor")
    p.add_argument("--genesis-validators", type=int, default=0, help="interop genesis with N validators")
    p.add_argument("--genesis-time", type=int, default=0)
    p.add_argument("--rest", action="store_true")
    p.add_argument("--rest-port", type=int, default=5052)
    p.add_argument(
        "--rest-auth-token-file",
        help="file holding the bearer token required on every REST request",
    )
    p.add_argument(
        "--rest-cors",
        help='CORS allowed origin for the REST API (e.g. "*")',
    )
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--metrics-port", type=int, default=8008)
    p.add_argument("--execution", default=None, help='"mock" or host:port of an EL engine API')
    p.add_argument("--eth1-endpoint", default=None, help="host:port of an eth1 JSON-RPC node (deposit follower)")
    p.add_argument("--eth1-deploy-block", type=int, default=0, help="deposit contract deployment block")
    p.add_argument("--jwt-secret", default=None, help="hex engine-API JWT secret")
    p.add_argument("--device", default="cuda",
                   help='device of the signature-verification stack ("cuda", "cuda:N" or "cpu")')
    p.add_argument("--run-seconds", type=float, default=0, help="exit after N seconds (0 = forever)")
    p.add_argument("--port", type=int, default=0, help="p2p TCP/UDP listen port (enables live networking; -1 = ephemeral)")
    p.add_argument("--bootnodes", default=None, help="comma-separated enr-tpu: records to bootstrap from")
    p.add_argument("--advertise-ip", default=None, help="external address advertised in the ENR")
    p.add_argument("--listen-address", default="127.0.0.1", help="p2p bind address (use 0.0.0.0 with --advertise-ip for WAN)")
    p.set_defaults(func=run_beacon)
