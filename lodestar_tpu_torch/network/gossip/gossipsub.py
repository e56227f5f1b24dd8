"""Gossipsub v1.1 router over the secure transport.

Reference: `network/gossip/gossipsub.ts:77` (`Eth2Gossipsub extends
GossipSub`) + `@chainsafe/libp2p-gossipsub`. Implements the v1.1 mesh
protocol: per-topic meshes bounded by D_LO ≤ D ≤ D_HI, heartbeat mesh
maintenance with score-aware GRAFT/PRUNE + prune backoff, fanout for
unsubscribed publishes, message-cache windows feeding IHAVE gossip,
IWANT recovery, flood-publish for own messages, and the v1.1 peer-score
gates (gossip/publish/graylist thresholds).

Ethereum profile: anonymous messages (content-derived msg-id via
`encoding.compute_msg_id`), ssz_snappy payloads, per-topic async
validators returning ACCEPT/IGNORE/REJECT wired by
`network/gossip/handlers.py`.

(The port's copy of the JAX package's `network/gossip/gossipsub.py`.)
"""

from __future__ import annotations

import logging
import asyncio
import random
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from enum import Enum

from .encoding import compute_msg_id
from .rpc import RPC, ControlIHave, ControlPrune, decode_rpc, encode_rpc
from .score import (
    DECAY_INTERVAL,
    GOSSIP_THRESHOLD,
    GRAYLIST_THRESHOLD,
    OPPORTUNISTIC_GRAFT_THRESHOLD,
    PUBLISH_THRESHOLD,
    PeerScore,
    PeerScoreParams,
)

GOSSIPSUB_PROTOCOL = "/meshsub/1.1.0"

# mesh degree bounds (gossipsub spec defaults, used by the reference)
D = 8
D_LO = 6
D_HI = 12
D_SCORE = 4  # mesh peers kept by score during pruning
D_LAZY = 6  # gossip emission degree
GOSSIP_FACTOR = 0.25
HEARTBEAT_INTERVAL = 0.7  # seconds (gossipsub spec)
MCACHE_GOSSIP = 3  # windows advertised in IHAVE
MCACHE_LEN = 6  # total history windows
SEEN_TTL = 120.0
PRUNE_BACKOFF = 60.0
FANOUT_TTL = 60.0
MAX_IHAVE_PER_HEARTBEAT = 5000
# per-peer IWANT service budget, reset each heartbeat (bandwidth-sink guard)
MAX_IWANT_SERVED_PER_HEARTBEAT = 512


def _topic_kind(topic: str) -> str:
    """Topic kind for metric labels (bounded cardinality: subnet topics
    collapse onto their kind)."""
    from .topic import parse_topic

    try:
        return parse_topic(topic).type.value
    except ValueError:
        return "unknown"

log = logging.getLogger(__name__)


class ValidationResult(str, Enum):
    ACCEPT = "ACCEPT"
    IGNORE = "IGNORE"
    REJECT = "REJECT"


class TimedSet:
    """Insertion-ordered set whose entries expire after a TTL."""

    def __init__(self, ttl: float, time_fn=time.monotonic):
        self.ttl = ttl
        self._time = time_fn
        self._items: OrderedDict[bytes, float] = OrderedDict()

    def put(self, key: bytes) -> bool:
        """True if newly added (not seen before)."""
        self._expire()
        if key in self._items:
            return False
        self._items[key] = self._time()
        return True

    def __contains__(self, key: bytes) -> bool:
        self._expire()
        return key in self._items

    def _expire(self) -> None:
        cutoff = self._time() - self.ttl
        while self._items:
            key, t = next(iter(self._items.items()))
            if t >= cutoff:
                break
            self._items.popitem(last=False)


class MessageCache:
    """Sliding windows of recent messages for IHAVE/IWANT (mcache)."""

    def __init__(self, gossip_windows: int = MCACHE_GOSSIP, total: int = MCACHE_LEN):
        self.gossip_windows = gossip_windows
        self.windows: list[list[tuple[bytes, str]]] = [[] for _ in range(total)]
        self.msgs: dict[bytes, tuple[str, bytes]] = {}

    def put(self, msg_id: bytes, topic: str, data: bytes) -> None:
        self.msgs[msg_id] = (topic, data)
        self.windows[0].append((msg_id, topic))

    def get(self, msg_id: bytes) -> tuple[str, bytes] | None:
        return self.msgs.get(msg_id)

    def gossip_ids(self, topic: str) -> list[bytes]:
        out = []
        for window in self.windows[: self.gossip_windows]:
            out.extend(mid for mid, t in window if t == topic)
        return out

    def shift(self) -> None:
        expired = self.windows.pop()
        for mid, _topic in expired:
            self.msgs.pop(mid, None)
        self.windows.insert(0, [])


@dataclass
class PeerState:
    peer_id: str
    send: object  # async callable(bytes) -> None
    topics: set[str] = field(default_factory=set)  # peer's subscriptions
    outbound: bool = False  # we dialed them (quota for mesh diversity)
    dont_send_until: dict[str, float] = field(default_factory=dict)  # prune backoff


class Gossipsub:
    """The router. Transport-agnostic: peers are attached with an async
    `send(bytes)`; incoming RPC bytes are fed to `on_rpc(peer_id, wire)`."""

    def __init__(
        self,
        score_params: PeerScoreParams | None = None,
        time_fn=time.monotonic,
        rng: random.Random | None = None,
    ):
        self.peers: dict[str, PeerState] = {}
        # per-peer IWANT messages served this heartbeat: lives on the
        # ROUTER (not PeerState) so connection churn cannot reset it —
        # mirroring how PeerScore retains scores across reconnects
        self._iwant_served: dict[str, int] = {}
        self.subscriptions: set[str] = set()
        self.mesh: dict[str, set[str]] = {}
        self.fanout: dict[str, set[str]] = {}
        self.fanout_last_pub: dict[str, float] = {}
        self.mcache = MessageCache()
        self.seen = TimedSet(SEEN_TTL, time_fn)
        self.score = PeerScore(score_params, time_fn)
        self.validators: dict[str, object] = {}  # topic prefix → async validator
        self._time = time_fn
        self._rng = rng or random.Random(0xE7)
        self._heartbeat_task: asyncio.Task | None = None
        self._last_decay = time_fn()
        self.on_message = None  # async (topic, ssz_wire) after ACCEPT — app tap
        self.metrics = None

    # ------------------------------------------------------------- peer admin

    def add_peer(self, peer_id: str, send, outbound: bool, ip: str | None = None) -> None:
        self.peers[peer_id] = PeerState(peer_id=peer_id, send=send, outbound=outbound)
        self.score.add_peer(peer_id, ip)

    def remove_peer(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)
        for peers in self.mesh.values():
            peers.discard(peer_id)
        for peers in self.fanout.values():
            peers.discard(peer_id)
        self.score.remove_peer(peer_id)

    # ---------------------------------------------------------- subscriptions

    async def subscribe(self, topic: str) -> None:
        if topic in self.subscriptions:
            return
        self.subscriptions.add(topic)
        self.mesh.setdefault(topic, set())
        # announce to all peers; graft happens at heartbeat (or join now)
        await self._broadcast(RPC(subscriptions=[(True, topic)]))
        await self._join(topic)

    async def unsubscribe(self, topic: str) -> None:
        if topic not in self.subscriptions:
            return
        self.subscriptions.discard(topic)
        peers = self.mesh.pop(topic, set())
        rpc = RPC(subscriptions=[(False, topic)], prune=[ControlPrune(topic)])
        for pid in peers:
            self.score.prune(pid, topic)
            await self._send(pid, rpc)
        others = RPC(subscriptions=[(False, topic)])
        for pid in self.peers:
            if pid not in peers:
                await self._send(pid, others)

    async def _join(self, topic: str) -> None:
        mesh = self.mesh.setdefault(topic, set())
        candidates = self._topic_peers(topic, exclude=mesh)
        add = self._select_peers(candidates, D - len(mesh))
        for pid in add:
            mesh.add(pid)
            self.score.graft(pid, topic)
            await self._send(pid, RPC(graft=[topic]))

    # ---------------------------------------------------------------- publish

    async def publish(self, topic: str, data: bytes) -> int:
        """Publish ssz_snappy wire data; returns receiver count.

        Flood-publish (v1.1 default): send to ALL known topic peers above
        the publish threshold, not just the mesh — hardens own messages
        against sybil meshes."""
        msg_id = compute_msg_id(topic, data)
        if not self.seen.put(msg_id):
            return 0
        self.mcache.put(msg_id, topic, data)
        targets = {
            pid
            for pid in self._topic_peers(topic)
            if self.score.score(pid) >= PUBLISH_THRESHOLD
        }
        if not targets and topic not in self.subscriptions:
            # fanout fallback when nobody known yet
            targets = self.fanout.setdefault(topic, set())
            self.fanout_last_pub[topic] = self._time()
        rpc = RPC(messages=[(topic, data)])
        for pid in targets:
            await self._send(pid, rpc)
        if self.metrics is not None:
            self.metrics.gossip_tx_total.inc()
        return len(targets)

    # ------------------------------------------------------------------ input

    async def on_rpc(self, peer_id: str, wire: bytes) -> None:
        peer = self.peers.get(peer_id)
        if peer is None:
            return
        if self.score.score(peer_id) < GRAYLIST_THRESHOLD:
            return  # graylisted: ignore everything
        try:
            rpc = decode_rpc(wire)
        except ValueError:
            self.score.add_behaviour_penalty(peer_id)
            return
        for subscribe, topic in rpc.subscriptions:
            (peer.topics.add if subscribe else peer.topics.discard)(topic)
            if not subscribe:
                self.mesh.get(topic, set()).discard(peer_id)
        for topic, data in rpc.messages:
            await self._handle_message(peer_id, topic, data)
        if rpc.graft or rpc.prune:
            await self._handle_graft_prune(peer, rpc)
        if rpc.ihave or rpc.iwant:
            await self._handle_gossip_control(peer, rpc)

    async def _handle_message(self, peer_id: str, topic: str, data: bytes) -> None:
        msg_id = compute_msg_id(topic, data)
        first = self.seen.put(msg_id)
        self.score.deliver_message(peer_id, topic, first=first)
        if not first:
            if self.metrics is not None:
                self.metrics.gossip_duplicates_total.inc()
            return
        if topic not in self.subscriptions:
            # not our topic: don't validate or forward
            return
        import time as _time

        t0 = _time.monotonic()
        result = await self._validate(topic, data)
        if self.metrics is not None:
            self.metrics.gossip_rx_total.inc(outcome=result.value)
            kind = _topic_kind(topic)
            self.metrics.gossip_validation_total.inc(
                kind=kind, outcome=result.value
            )
            self.metrics.gossip_validation_seconds.observe(
                _time.monotonic() - t0, kind=kind
            )
        if result is ValidationResult.REJECT:
            self.score.reject_message(peer_id, topic)
            return
        if result is ValidationResult.IGNORE:
            return
        self.mcache.put(msg_id, topic, data)
        await self._forward(topic, data, exclude={peer_id})
        if self.on_message is not None:
            await self.on_message(topic, data)

    async def _validate(self, topic: str, data: bytes) -> ValidationResult:
        validator = self.validators.get(topic)
        if validator is None:
            # prefix match (subnet topics share one validator)
            for prefix, v in self.validators.items():
                if topic.startswith(prefix):
                    validator = v
                    break
        if validator is None:
            return ValidationResult.ACCEPT
        try:
            return await validator(topic, data)
        except Exception as e:  # validator crash = ignore, never forward
            log.debug(f"validator error on {topic}: {e}")
            return ValidationResult.IGNORE

    async def _forward(self, topic: str, data: bytes, exclude: set[str]) -> None:
        mesh = self.mesh.get(topic, set())
        rpc = RPC(messages=[(topic, data)])
        for pid in mesh - exclude:
            await self._send(pid, rpc)

    async def _handle_graft_prune(self, peer: PeerState, rpc: RPC) -> None:
        if self.metrics is not None:
            if rpc.graft:
                self.metrics.gossip_graft_rx_total.inc(len(rpc.graft))
            if rpc.prune:
                self.metrics.gossip_prune_rx_total.inc(len(rpc.prune))
        prunes = []
        now = self._time()
        for topic in rpc.graft:
            mesh = self.mesh.get(topic)
            backoff = peer.dont_send_until.get(topic, 0.0)
            if mesh is None:
                prunes.append(ControlPrune(topic))  # not subscribed
            elif backoff > now:
                # grafting inside backoff is a protocol violation (v1.1)
                self.score.add_behaviour_penalty(peer.peer_id)
                prunes.append(ControlPrune(topic))
            elif self.score.score(peer.peer_id) < 0:
                prunes.append(ControlPrune(topic))
            else:
                mesh.add(peer.peer_id)
                self.score.graft(peer.peer_id, topic)
                if self.metrics is not None:
                    self.metrics.gossip_mesh_churn_total.inc(direction="graft")
        for pr in rpc.prune:
            mesh = self.mesh.get(pr.topic)
            if mesh is not None and peer.peer_id in mesh:
                mesh.discard(peer.peer_id)
                self.score.prune(peer.peer_id, pr.topic)
                if self.metrics is not None:
                    self.metrics.gossip_mesh_churn_total.inc(direction="prune")
            peer.dont_send_until[pr.topic] = now + pr.backoff_sec
        if prunes:
            await self._send(peer.peer_id, RPC(prune=prunes))

    async def _handle_gossip_control(self, peer: PeerState, rpc: RPC) -> None:
        peer_score = self.score.score(peer.peer_id)  # once per RPC
        if self.metrics is not None:
            if rpc.ihave:
                self.metrics.gossip_ihave_rx_total.inc(
                    sum(len(ih.msg_ids) for ih in rpc.ihave)
                )
            if rpc.iwant:
                self.metrics.gossip_iwant_rx_total.inc(len(rpc.iwant))
        # IHAVE → request unseen ids (only from peers above gossip threshold)
        if rpc.ihave and peer_score >= GOSSIP_THRESHOLD:
            want = []
            for ih in rpc.ihave:
                if ih.topic not in self.subscriptions:
                    continue
                want.extend(mid for mid in ih.msg_ids if mid not in self.seen)
            if want:
                await self._send(peer.peer_id, RPC(iwant=want[:MAX_IHAVE_PER_HEARTBEAT]))
        # IWANT → serve from mcache, gated on peer score and a per-peer
        # per-heartbeat budget (without the quota a
        # graylist-adjacent peer can re-request the whole cache every RPC
        # and use the node as a bandwidth sink; the v1.1 spec expects
        # IWANT service limits — reference gossipsub MAX_IWANT quota)
        if rpc.iwant and peer_score >= GOSSIP_THRESHOLD:
            budget = MAX_IWANT_SERVED_PER_HEARTBEAT - self._iwant_served.get(
                peer.peer_id, 0
            )
            if budget > 0:
                msgs = []
                examined = 0
                for mid in rpc.iwant:
                    if len(msgs) >= budget:
                        break  # budget counts SERVED messages, not ids
                    examined += 1
                    entry = self.mcache.get(mid)
                    if entry is not None:
                        msgs.append(entry)
                if self.metrics is not None:
                    # only ids the serve loop never reached were gated by
                    # the budget; examined-but-expired ids are not drops
                    skipped = len(rpc.iwant) - examined
                    if skipped > 0:
                        self.metrics.gossip_iwant_budget_drops_total.inc(skipped)
                if msgs:
                    self._iwant_served[peer.peer_id] = (
                        self._iwant_served.get(peer.peer_id, 0) + len(msgs)
                    )
                    if self.metrics is not None:
                        self.metrics.gossip_iwant_served_total.inc(len(msgs))
                    await self._send(peer.peer_id, RPC(messages=msgs))
            elif self.metrics is not None:
                # budget exhausted before this RPC: everything requested
                # was gated by the budget
                self.metrics.gossip_iwant_budget_drops_total.inc(len(rpc.iwant))

    # -------------------------------------------------------------- heartbeat

    def start_heartbeat(self) -> None:
        self._heartbeat_task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            try:
                await self._heartbeat_task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(HEARTBEAT_INTERVAL)
            try:
                await self.heartbeat()
            except Exception as e:  # noqa: BLE001
                log.debug(f"heartbeat error: {e}")

    async def heartbeat(self) -> None:
        now = self._time()
        self._iwant_served.clear()  # refresh the per-heartbeat IWANT budgets
        if now - self._last_decay >= DECAY_INTERVAL:
            self.score.decay()
            self._last_decay = now

        for topic in list(self.subscriptions):
            mesh = self.mesh.setdefault(topic, set())
            # drop negative-score mesh members
            for pid in [p for p in mesh if self.score.score(p) < 0]:
                mesh.discard(pid)
                self.score.prune(pid, topic)
                await self._send_prune(pid, topic)
            # grow to D
            if len(mesh) < D_LO:
                candidates = [
                    pid
                    for pid in self._topic_peers(topic, exclude=mesh)
                    if self.score.score(pid) >= 0
                    and self.peers[pid].dont_send_until.get(topic, 0.0) <= now
                ]
                for pid in self._select_peers(candidates, D - len(mesh)):
                    mesh.add(pid)
                    self.score.graft(pid, topic)
                    await self._send(pid, RPC(graft=[topic]))
            # shrink to D, keeping the best D_SCORE by score
            elif len(mesh) > D_HI:
                ranked = sorted(mesh, key=lambda p: -self.score.score(p))
                keep = set(ranked[:D_SCORE])
                pool = [p for p in ranked[D_SCORE:]]
                self._rng.shuffle(pool)
                keep.update(pool[: D - D_SCORE])
                for pid in list(mesh - keep):
                    mesh.discard(pid)
                    self.score.prune(pid, topic)
                    await self._send_prune(pid, topic)
            # opportunistic grafting: median mesh score too low → add good peers
            elif len(mesh) >= D_LO:
                scores = sorted(self.score.score(p) for p in mesh)
                median = scores[len(scores) // 2] if scores else 0.0
                if median < OPPORTUNISTIC_GRAFT_THRESHOLD:
                    candidates = [
                        pid
                        for pid in self._topic_peers(topic, exclude=mesh)
                        if self.score.score(pid) > median
                        and self.peers[pid].dont_send_until.get(topic, 0.0) <= now
                    ]
                    for pid in self._select_peers(candidates, 2):
                        mesh.add(pid)
                        self.score.graft(pid, topic)
                        await self._send(pid, RPC(graft=[topic]))

            # emit IHAVE gossip to a random slice of non-mesh topic peers
            ids = self.mcache.gossip_ids(topic)
            if ids:
                others = [
                    pid
                    for pid in self._topic_peers(topic, exclude=mesh)
                    if self.score.score(pid) >= GOSSIP_THRESHOLD
                ]
                k = max(D_LAZY, int(GOSSIP_FACTOR * len(others)))
                self._rng.shuffle(others)
                ih = RPC(ihave=[ControlIHave(topic, ids[:MAX_IHAVE_PER_HEARTBEAT])])
                for pid in others[:k]:
                    await self._send(pid, ih)

        # expire fanout
        for topic in list(self.fanout):
            if now - self.fanout_last_pub.get(topic, 0.0) > FANOUT_TTL:
                del self.fanout[topic]
                self.fanout_last_pub.pop(topic, None)

        self.mcache.shift()

    async def _send_prune(self, pid: str, topic: str) -> None:
        await self._send(pid, RPC(prune=[ControlPrune(topic, int(PRUNE_BACKOFF))]))

    # ------------------------------------------------------------------ utils

    def _topic_peers(self, topic: str, exclude: set[str] | None = None) -> list[str]:
        exclude = exclude or set()
        return [
            pid
            for pid, peer in self.peers.items()
            if topic in peer.topics and pid not in exclude
        ]

    def _select_peers(self, candidates: list[str], count: int) -> list[str]:
        if count <= 0:
            return []
        pool = list(candidates)
        self._rng.shuffle(pool)
        return pool[:count]

    async def _send(self, peer_id: str, rpc: RPC) -> None:
        peer = self.peers.get(peer_id)
        if peer is None or rpc.is_empty():
            return
        try:
            await peer.send(encode_rpc(rpc))
        except Exception:  # dead pipe → drop peer
            self.remove_peer(peer_id)

    async def _broadcast(self, rpc: RPC) -> None:
        for pid in list(self.peers):
            await self._send(pid, rpc)


class GossipsubService:
    """Binds a Gossipsub router to the secure Transport: one outbound
    gossip stream per connection for sending, inbound stream frames fed to
    the router (mirrors libp2p's per-direction streams)."""

    def __init__(self, transport, router: Gossipsub | None = None):
        self.transport = transport
        self.router = router or Gossipsub()
        transport.set_stream_handler(GOSSIPSUB_PROTOCOL, self._on_stream)
        transport.on_connection.append(self._on_connection)

    def _on_connection(self, conn) -> None:
        asyncio.get_running_loop().create_task(self._attach(conn))

    async def _attach(self, conn) -> None:
        try:
            stream = await conn.open_stream(GOSSIPSUB_PROTOCOL)
        except Exception:
            return
        lock = asyncio.Lock()

        async def send(data: bytes) -> None:
            async with lock:
                await stream.write(len(data).to_bytes(4, "big") + data)

        self.router.add_peer(conn.peer_id, send, outbound=conn.initiator)

        # only drop the router peer if this conn is still the live one —
        # an _adopt-replaced conn closing must not evict its successor
        def on_close(c=conn):
            if self.transport.connections.get(c.peer_id) is None:
                self.router.remove_peer(c.peer_id)

        conn.on_close.append(on_close)
        # announce current subscriptions to the new peer
        subs = [(True, t) for t in self.router.subscriptions]
        if subs:
            await self.router._send(conn.peer_id, RPC(subscriptions=subs))

    async def _on_stream(self, stream) -> None:
        """Inbound gossip stream: length-prefixed RPC frames."""
        buf = b""
        while True:
            chunk = await stream.read()
            if chunk is None:
                return
            buf += chunk
            while len(buf) >= 4:
                n = int.from_bytes(buf[:4], "big")
                if n > 10 * 2**20:
                    await stream.reset()
                    return
                if len(buf) < 4 + n:
                    break
                frame, buf = buf[4 : 4 + n], buf[4 + n :]
                await self.router.on_rpc(stream.conn.peer_id, frame)
