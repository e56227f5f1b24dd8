"""Network facade: transport + gossip + reqresp + peers + subnets.

Reference: `network/network.ts:39` — the `Network` class owns
`Eth2Gossipsub`, `ReqResp`, `PeerManager`, attnets/syncnets services and
the fork-transition topic logic (`subscribeGossipCoreTopics` :225, and
subscribing both fork digests ±epochs around a scheduled fork,
network.ts:39-110).

(The port's copy of the JAX package's `network/network.py`.)
"""

from __future__ import annotations

import logging
import asyncio

from .gossip.gossipsub import Gossipsub, GossipsubService
from .gossip.handlers import GossipHandlers
from .gossip.score import PeerScoreParams, ethereum_topic_params
from .gossip.topic import GossipTopic, GossipType, stringify_topic
from .peers import PeerAction, PeerManager
from .reqresp.handlers import ReqRespHandlers
from .reqresp.service import RemotePeer, ReqRespService
from .subnets import AttnetsService
from .transport import NodeIdentity, Transport

log = logging.getLogger(__name__)

CORE_TOPICS = [
    GossipType.beacon_block,
    GossipType.beacon_aggregate_and_proof,
    GossipType.voluntary_exit,
    GossipType.proposer_slashing,
    GossipType.attester_slashing,
]

HEARTBEAT_SEC = 2.0
DIAL_TIMEOUT = 5.0  # TCP connect + handshake, per dial attempt


class Network:
    """One object the node wires in; start() listens, connect() dials."""

    def __init__(
        self,
        config,
        types,
        chain,
        identity: NodeIdentity | None = None,
        verify_signatures: bool = True,
        subscribe_all_subnets: bool = False,
        metrics=None,
        fleet_router=None,
        persist_invalid_dir: str | None = None,
    ):
        self.metrics = metrics
        self.config = config
        self.types = types
        self.chain = chain
        self.transport = Transport(identity)
        self.peer_id = self.transport.peer_id
        self.peer_manager = PeerManager()
        self.subscribe_all_subnets = subscribe_all_subnets

        # gossip: Ethereum score params for the topics we will join
        score_params = PeerScoreParams()
        self.gossip = Gossipsub(score_params)
        self.gossip.metrics = metrics
        self.gossip_service = GossipsubService(self.transport, self.gossip)
        self.gossip_handlers = GossipHandlers(
            config, types, chain, verify_signatures=verify_signatures,
            fleet_router=fleet_router, persist_invalid_dir=persist_invalid_dir,
        )
        self.gossip_handlers.register(self.gossip)
        self._score_params = score_params

        # reqresp
        self.reqresp_handlers = ReqRespHandlers(config, types, chain)
        self.reqresp = ReqRespService(
            self.transport, self.reqresp_handlers, types, self.peer_manager,
            metrics=_ReqRespMetricsAdapter(metrics) if metrics is not None else None,
        )

        # subnets
        from .subnets import SyncnetsService

        node_id = bytes.fromhex(self.peer_id)
        self.attnets = AttnetsService(node_id, config.preset.SLOTS_PER_EPOCH)
        self.syncnets = SyncnetsService(config.preset.SLOTS_PER_EPOCH)

        self.discovery = None  # enabled via start(discovery=True)
        self._dial_backoff: dict[str, float] = {}  # node_id → retry-after
        self._queue_drops_seen: dict[str, int] = {}  # per-topic drop watermark
        self._mesh_kinds_seen: set[str] = set()

        self._heartbeat_task: asyncio.Task | None = None
        self.transport.on_connection.append(self._on_connection)

    # -- lifecycle -----------------------------------------------------------

    async def start(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        discovery: bool = False,
        bootnodes: list | None = None,
        advertise_ip: str | None = None,
    ) -> tuple[str, int]:
        addr = await self.transport.listen(host, port)
        if discovery or bootnodes:
            # the ENR must carry a dialable address — a wildcard bind is not
            # one, so an explicit advertise_ip is required off-loopback
            ip = advertise_ip or addr[0]
            if ip in ("0.0.0.0", "::"):
                log.warning("wildcard bind with no advertise_ip; ENR uses loopback")
                ip = "127.0.0.1"
            await self._start_discovery((ip, addr[1]), bootnodes or [], bind_host=host)
        await self.subscribe_gossip_core_topics()
        self.gossip.start_heartbeat()
        self._heartbeat_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop()
        )
        return addr

    async def _start_discovery(
        self, advertise_addr, bootnodes: list, bind_host: str | None = None
    ) -> None:
        from .discovery import ENR, Discovery

        epoch = self.chain.clock.current_epoch
        enr = ENR(
            node_id=self.peer_id,
            pubkey=self.transport.identity.public_bytes,
            ip=advertise_addr[0],
            tcp_port=advertise_addr[1],
            udp_port=0,
            fork_digest=self._fork_digests_now()[0],
        )
        attnets = self.attnets.enr_attnets(epoch)
        self.discovery = Discovery(self.transport.identity, enr)
        self.discovery.metrics = self.metrics
        self.discovery.update_attnets(attnets)
        self.discovery.on_discovered.append(self._on_discovered)
        await self.discovery.start(bind_host or advertise_addr[0])
        self.discovery.start_liveness_loop()
        if bootnodes:
            await self.discovery.bootstrap(bootnodes)

    def _on_discovered(self, enr) -> None:
        """Dial newly-discovered peers while below the connection target
        (reference: PeerManager consuming discv5 discoveries); at target,
        the heartbeat re-dials from the discovery table when slots free."""
        if enr.node_id in self.transport.connections:
            return
        if len(self.transport.connections) >= self.peer_manager.target_peers:
            return
        asyncio.get_running_loop().create_task(self._dial_enr(enr))

    def _may_dial(self, node_id: str, now: float) -> bool:
        from .peers import ScoreState as _SS

        if self.peer_manager.scores.state(node_id) == _SS.Banned:
            return False
        return self._dial_backoff.get(node_id, 0.0) <= now

    async def _dial_enr(self, enr) -> None:
        import time as _time

        now = _time.monotonic()
        if not self._may_dial(enr.node_id, now):
            return
        # exponential per-peer backoff so dead records don't get a fresh
        # connect attempt every heartbeat
        prev = self._dial_backoff.get(enr.node_id)
        delay = DIAL_TIMEOUT if prev is None else min(
            300.0, max(DIAL_TIMEOUT, (prev - now) * 2 if prev > now else DIAL_TIMEOUT * 2)
        )
        self._dial_backoff[enr.node_id] = now + delay
        try:
            await asyncio.wait_for(self.connect(enr.ip, enr.tcp_port), DIAL_TIMEOUT)
            self._dial_backoff.pop(enr.node_id, None)
        except Exception as e:
            log.debug(f"dial {enr.node_id[:8]} failed: {e}")

    async def stop(self) -> None:
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            try:
                await self._heartbeat_task
            except asyncio.CancelledError:
                pass
        await self.gossip.stop()
        if self.discovery is not None:
            self.discovery.stop()
        for q in self.gossip_handlers.queues.values():
            q.close()
        await self.transport.close()

    async def connect(self, host: str, port: int):
        conn = await self.transport.dial(host, port)
        return conn

    # -- topic management ----------------------------------------------------

    def _fork_digests_now(self) -> list[bytes]:
        """Digests to subscribe: current fork, plus the next fork's digest
        around a scheduled transition (reference network.ts fork logic)."""
        epoch = self.chain.clock.current_epoch
        return [
            self.config.fork_digest(f)
            for f in self.config.get_active_forks_around_epoch(epoch)
        ]

    async def subscribe_gossip_core_topics(self) -> None:
        for digest in self._fork_digests_now():
            for gtype in CORE_TOPICS:
                topic_str = stringify_topic(GossipTopic(gtype, digest))
                self._ensure_topic_params(topic_str)
                await self.gossip.subscribe(topic_str)
            # altair+ digests also carry the sync-committee topics
            fork = self.config.fork_name_from_digest(digest)
            if fork not in ("phase0",):
                for gtype in (
                    GossipType.sync_committee_contribution_and_proof,
                    GossipType.light_client_finality_update,
                    GossipType.light_client_optimistic_update,
                ):
                    topic_str = stringify_topic(GossipTopic(gtype, digest))
                    self._ensure_topic_params(topic_str)
                    await self.gossip.subscribe(topic_str)
                epoch = self.chain.clock.current_epoch
                for subnet in sorted(self.syncnets.active_subnets(epoch)):
                    topic_str = stringify_topic(
                        GossipTopic(GossipType.sync_committee, digest, subnet)
                    )
                    self._ensure_topic_params(topic_str)
                    await self.gossip.subscribe(topic_str)
            subnets = (
                range(64)
                if self.subscribe_all_subnets
                else sorted(self.attnets.active_subnets(self.chain.clock.current_epoch))
            )
            for subnet in subnets:
                await self.subscribe_subnet(subnet, digest)

    async def subscribe_subnet(self, subnet: int, digest: bytes | None = None) -> None:
        digests = [digest] if digest is not None else self._fork_digests_now()
        for d in digests:
            topic = GossipTopic(GossipType.beacon_attestation, d, subnet)
            await self.gossip.subscribe(stringify_topic(topic))
            self._ensure_topic_params(stringify_topic(topic))

    def _ensure_topic_params(self, topic_str: str) -> None:
        if topic_str not in self._score_params.topics:
            kind = topic_str.split("/")[3]
            base = kind.rsplit("_", 1)[0] if kind.rsplit("_", 1)[-1].isdigit() else kind
            self._score_params.topics[topic_str] = ethereum_topic_params(base)

    async def publish_block(self, signed_block) -> int:
        from .gossip.encoding import encode_message

        digest = self.config.fork_digest(
            self.config.get_fork_name_at_slot(int(signed_block.message.slot))
        )
        topic = stringify_topic(GossipTopic(GossipType.beacon_block, digest))
        return await self.gossip.publish(topic, encode_message(signed_block.serialize()))

    async def publish_attestation(self, attestation, subnet: int) -> int:
        from .gossip.encoding import encode_message

        digest = self.config.fork_digest(
            self.config.get_fork_name_at_slot(int(attestation.data.slot))
        )
        topic = stringify_topic(
            GossipTopic(GossipType.beacon_attestation, digest, subnet)
        )
        return await self.gossip.publish(topic, encode_message(attestation.serialize()))

    async def publish_aggregate(self, signed_agg) -> int:
        from .gossip.encoding import encode_message

        digest = self.config.fork_digest(
            self.config.get_fork_name_at_slot(
                int(signed_agg.message.aggregate.data.slot)
            )
        )
        topic = stringify_topic(
            GossipTopic(GossipType.beacon_aggregate_and_proof, digest)
        )
        return await self.gossip.publish(topic, encode_message(signed_agg.serialize()))

    # -- peers ---------------------------------------------------------------

    def _on_connection(self, conn) -> None:
        if not self.peer_manager.on_connect(
            conn.peer_id, "outbound" if conn.initiator else "inbound"
        ):
            asyncio.get_running_loop().create_task(conn.close())
            return
        # a replaced connection (simultaneous cross-dial) must not tear down
        # the live successor's PeerInfo — only the CURRENT conn's close counts
        def on_close(c=conn):
            if self.transport.connections.get(c.peer_id) is None:
                self.peer_manager.on_disconnect(c.peer_id)

        conn.on_close.append(on_close)
        asyncio.get_running_loop().create_task(self._status_handshake(conn.peer_id))

    async def _status_handshake(self, peer_id: str) -> None:
        try:
            status = await self.reqresp.status(peer_id)
            self.peer_manager.on_status(peer_id, status)
        except Exception as e:
            # peers that never answer status get pruned by scoring
            log.debug("status handshake with %s failed: %s", peer_id, e)

    def sync_peers(self, loop: asyncio.AbstractEventLoop) -> list[RemotePeer]:
        """RemotePeer views of all connected peers for the sync layer."""
        return [
            RemotePeer(self.reqresp, pid, loop)
            for pid in self.transport.connections
        ]

    async def _refresh_subnet_subscriptions(self) -> None:
        """Join any newly-active duty subnets (attnets short-lived +
        syncnets membership change after start) and prune expired ones —
        the dynamic half of the reference's subnet services."""
        epoch = self.chain.clock.current_epoch
        self.syncnets.prune(epoch)
        for digest in self._fork_digests_now():
            for subnet in self.attnets.active_subnets(epoch):
                topic = stringify_topic(
                    GossipTopic(GossipType.beacon_attestation, digest, subnet)
                )
                if topic not in self.gossip.subscriptions:
                    await self.subscribe_subnet(subnet, digest)
            if self.config.fork_name_from_digest(digest) != "phase0":
                for subnet in self.syncnets.active_subnets(epoch):
                    topic = stringify_topic(
                        GossipTopic(GossipType.sync_committee, digest, subnet)
                    )
                    if topic not in self.gossip.subscriptions:
                        self._ensure_topic_params(topic)
                        await self.gossip.subscribe(topic)

    def _export_metrics(self) -> None:
        m = self.metrics
        if m is None:
            return
        m.peers_connected.set(len(self.transport.connections))
        if self.discovery is not None:
            m.discovery_table_size.set(len(self.discovery.table))
            m.discv5_endpoint_proofs.set(len(self.discovery._endpoint_proven))
            m.discv5_pending_challenges.set(len(self.discovery._ping_addr))
        from .gossip.topic import parse_topic

        by_kind: dict[str, int] = {}
        for topic, mesh in self.gossip.mesh.items():
            try:
                kind = parse_topic(topic).type.value
            except ValueError:
                continue
            by_kind[kind] = by_kind.get(kind, 0) + len(mesh)
        # zero kinds that left the mesh so stale gauge series don't linger
        for kind in self._mesh_kinds_seen - set(by_kind):
            m.gossip_mesh_peers.set(0, kind=kind)
        self._mesh_kinds_seen |= set(by_kind)
        for kind, size in by_kind.items():
            m.gossip_mesh_peers.set(size, kind=kind)
        # peer-score distribution (reference gossipsub scores dashboard)
        scores = [
            self.gossip.score.score(pid) for pid in self.gossip.peers
        ]
        if scores:
            bands = {"negative": 0, "zero": 0, "positive": 0}
            for sc in scores:
                if sc < 0:
                    bands["negative"] += 1
                elif sc > 0:
                    bands["positive"] += 1
                else:
                    bands["zero"] += 1
            for band, n in bands.items():
                m.gossip_peers_by_score.set(n, band=band)
            m.gossip_score_min.set(min(scores))
            m.gossip_score_max.set(max(scores))
        # process health
        try:
            import os as _os

            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            m.process_rss_bytes.set(rss_pages * _os.sysconf("SC_PAGE_SIZE"))
        except (OSError, ValueError, IndexError):
            pass  # no /proc (non-Linux): RSS gauge simply stays unset
        try:
            import os as _os

            m.open_fds.set(len(_os.listdir("/proc/self/fd")))
        except OSError:
            pass  # no /proc (non-Linux): fd gauge simply stays unset
        for gtype, queue in self.gossip_handlers.queues.items():
            m.gossip_queue_length.set(len(queue), topic=gtype.value)
            seen = self._queue_drops_seen.get(gtype.value, 0)
            dropped = queue.metrics.dropped_jobs
            if dropped > seen:
                m.gossip_queue_dropped_total.inc(dropped - seen, topic=gtype.value)
                self._queue_drops_seen[gtype.value] = dropped

    async def _heartbeat_loop(self) -> None:
        while True:
            t0 = asyncio.get_running_loop().time()
            await asyncio.sleep(HEARTBEAT_SEC)
            if self.metrics is not None:
                # scheduling overshoot of the sleep = event-loop lag
                lag = asyncio.get_running_loop().time() - t0 - HEARTBEAT_SEC
                self.metrics.event_loop_lag_seconds.set(max(0.0, lag))
            try:
                self._export_metrics()
                await self._refresh_subnet_subscriptions()
                # below-target: dial peers known to discovery but not yet
                # connected (reference: PeerManager discover-on-heartbeat).
                # Dials are concurrent, time-capped tasks, at most enough to
                # reach the target — a stale ENR must not stall the beat
                if self.discovery is not None:
                    want = self.peer_manager.target_peers - len(
                        self.transport.connections
                    )
                    if want > 0:
                        import time as _time

                        now = _time.monotonic()
                        candidates = [
                            enr
                            for enr in self.discovery.table.all()
                            if enr.node_id not in self.transport.connections
                            and self._may_dial(enr.node_id, now)
                        ][:want]
                        for enr in candidates:
                            asyncio.get_running_loop().create_task(
                                self._dial_enr(enr)
                            )
                # feed gossip scores into the peer manager: deep gossip
                # negatives become actionable peer-manager penalties so the
                # prune pass below disconnects/bans them
                from .gossip.score import GRAYLIST_THRESHOLD, PUBLISH_THRESHOLD

                for pid in list(self.transport.connections):
                    gscore = self.gossip.score.score(pid)
                    if gscore <= GRAYLIST_THRESHOLD:
                        self.peer_manager.report_peer(pid, PeerAction.Fatal)
                    elif gscore <= PUBLISH_THRESHOLD:
                        self.peer_manager.report_peer(
                            pid, PeerAction.LowToleranceError
                        )
                to_drop = self.peer_manager.heartbeat()
                for pid in to_drop:
                    conn = self.transport.connections.get(pid)
                    if conn is not None:
                        await self.reqresp.goodbye(pid)
                        await conn.close()
            except Exception as e:  # noqa: BLE001
                log.debug(f"network heartbeat error: {e}")

    def report_peer(self, peer_id: str, action: PeerAction) -> None:
        self.peer_manager.report_peer(peer_id, action)


class _ReqRespMetricsAdapter:
    """Bridges ReqRespService's observe hooks onto the metric registry
    (per-protocol latency, request/byte/error counters, rate limits —
    reference metric families: lodestar.ts reqResp.*)."""

    def __init__(self, metrics):
        self._metrics = metrics

    def observe_reqresp(self, protocol: str, seconds: float) -> None:
        self._metrics.reqresp_seconds.observe(seconds, protocol=protocol)

    def incoming_request(self, protocol: str) -> None:
        self._metrics.reqresp_incoming_requests_total.inc(protocol=protocol)

    def incoming_error(self, protocol: str) -> None:
        self._metrics.reqresp_incoming_errors_total.inc(protocol=protocol)

    def outgoing_request(self, protocol: str) -> None:
        self._metrics.reqresp_outgoing_requests_total.inc(protocol=protocol)

    def outgoing_error(self, protocol: str) -> None:
        self._metrics.reqresp_outgoing_errors_total.inc(protocol=protocol)

    def bytes_sent(self, protocol: str, n: int) -> None:
        self._metrics.reqresp_bytes_sent_total.inc(n, protocol=protocol)

    def bytes_received(self, protocol: str, n: int) -> None:
        self._metrics.reqresp_bytes_received_total.inc(n, protocol=protocol)

    def rate_limited(self, limiter: str) -> None:
        self._metrics.reqresp_rate_limited_total.inc(limiter=limiter)

    def response_chunk(self, code: str, n: int = 1) -> None:
        self._metrics.reqresp_response_chunks_total.inc(n, code=code)
