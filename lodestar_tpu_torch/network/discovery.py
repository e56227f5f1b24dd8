"""Peer discovery: signed node records + Kademlia lookups over UDP.

Reference: `@chainsafe/discv5` used by `network/peers/discover.ts` —
ENR records, k-bucket routing table keyed by XOR distance, iterative
FINDNODE lookups, and subnet-targeted peer queries (attnets bitfield in
the ENR, `discover.ts` subnet queries).

Native re-design notes: records are SSZ-style binary signed with the
node's ed25519 identity key (the same key that authenticates the
transport handshake, so a discovered record is attributable to the peer
you will dial); packets are individually signed rather than running
discv5's session handshake — the transport layer provides the
authenticated channel, discovery only needs spoofing-resistant
liveness/topology hints.

(The port's copy of the JAX package's `network/discovery.py`.)
"""

from __future__ import annotations

import logging
import asyncio
import struct
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..params import ATTESTATION_SUBNET_COUNT
from ..ssz.hashing import sha256
from .transport import NodeIdentity, peer_id_from_pubkey, verify_identity

log = logging.getLogger(__name__)

K_BUCKET_SIZE = 16
ALPHA = 3  # lookup concurrency
MAX_PACKET = 1280  # discv5 MTU discipline
PING_INTERVAL = 30.0
RECORD_TTL = 600.0
# endpoint-proof challenge bookkeeping bounds (identity minting is free,
# so these maps must not grow with attacker traffic)
_CHALLENGE_TTL = 5.0
_MAX_CHALLENGES = 512
_PROVEN_MAX = 4096
_KEYS_MAX = 16384
_CHALLENGE_PINGS_PER_SEC = 64.0  # global budget for challenge PINGs
_NONCE_WINDOW_SEC = 600.0  # max accepted sender-clock age (anti-replay)


def _lru_put(d: "OrderedDict", key, value, cap: int) -> None:
    d[key] = value
    d.move_to_end(key)
    while len(d) > cap:
        d.popitem(last=False)

_PING = 1
_PONG = 2
_FINDNODE = 3
_NODES = 4
_PTYPE_NAMES = {_PING: "ping", _PONG: "pong", _FINDNODE: "findnode", _NODES: "nodes"}


@dataclass
class ENR:
    """Signed node record (role of discv5's ENR)."""

    node_id: str  # transport peer id (hex of sha256(pubkey)[:20])
    pubkey: bytes  # ed25519, 32B
    ip: str
    tcp_port: int
    udp_port: int
    seq: int = 1
    fork_digest: bytes = b"\x00\x00\x00\x00"
    attnets: int = 0  # bitfield as int, bit i = subnet i
    signature: bytes = b""

    def signing_payload(self) -> bytes:
        import socket

        try:
            ip_raw = socket.inet_pton(socket.AF_INET, self.ip)
        except OSError:
            ip_raw = socket.inet_pton(socket.AF_INET6, self.ip)
        return (
            b"enr:"
            + self.pubkey
            + struct.pack(">QHH", self.seq, self.tcp_port, self.udp_port)
            + bytes([len(ip_raw)])
            + ip_raw
            + self.fork_digest
            + self.attnets.to_bytes(ATTESTATION_SUBNET_COUNT // 8, "little")
        )

    def sign(self, identity: NodeIdentity) -> "ENR":
        self.signature = identity.sign(self.signing_payload())
        return self

    def verify(self) -> bool:
        return (
            peer_id_from_pubkey(self.pubkey) == self.node_id
            and verify_identity(self.pubkey, self.signature, self.signing_payload())
        )

    def has_attnet(self, subnet: int) -> bool:
        return bool(self.attnets >> subnet & 1)

    def encode(self) -> bytes:
        payload = self.signing_payload()
        return struct.pack(">H", len(payload)) + payload + self.signature

    @classmethod
    def decode(cls, data: bytes, offset: int = 0) -> tuple["ENR", int]:
        (plen,) = struct.unpack_from(">H", data, offset)
        payload = data[offset + 2 : offset + 2 + plen]
        sig = data[offset + 2 + plen : offset + 2 + plen + 64]
        if len(payload) != plen or len(sig) != 64 or payload[:4] != b"enr:":
            raise ValueError("bad ENR encoding")
        pubkey = payload[4:36]
        seq, tcp_port, udp_port = struct.unpack_from(">QHH", payload, 36)
        import socket

        ip_len = payload[48]
        ip_raw = payload[49 : 49 + ip_len]
        family = socket.AF_INET if ip_len == 4 else socket.AF_INET6
        ip = socket.inet_ntop(family, ip_raw)
        rest = payload[49 + ip_len :]
        fork_digest = rest[:4]
        attnets = int.from_bytes(rest[4 : 4 + ATTESTATION_SUBNET_COUNT // 8], "little")
        enr = cls(
            node_id=peer_id_from_pubkey(pubkey),
            pubkey=pubkey,
            ip=ip,
            tcp_port=tcp_port,
            udp_port=udp_port,
            seq=seq,
            fork_digest=fork_digest,
            attnets=attnets,
            signature=sig,
        )
        return enr, offset + 2 + plen + 64


def _distance(a: str, b: str) -> int:
    """XOR distance over hashed ids (discv5 log2-distance basis)."""
    ha = int.from_bytes(sha256(bytes.fromhex(a)), "big")
    hb = int.from_bytes(sha256(bytes.fromhex(b)), "big")
    return ha ^ hb


@dataclass
class _BucketEntry:
    enr: ENR
    last_seen: float = field(default_factory=time.monotonic)


class RoutingTable:
    """256 k-buckets by log2(xor distance)."""

    def __init__(self, local_id: str):
        self.local_id = local_id
        self.buckets: list[dict[str, _BucketEntry]] = [dict() for _ in range(256)]

    def _bucket_of(self, node_id: str) -> dict[str, _BucketEntry]:
        d = _distance(self.local_id, node_id)
        return self.buckets[d.bit_length() - 1 if d else 0]

    def update(self, enr: ENR) -> bool:
        """Insert/refresh; True only when the node is NEW to the table (the
        discovered-callback trigger — refreshes are not discoveries)."""
        if enr.node_id == self.local_id or not enr.verify():
            return False
        bucket = self._bucket_of(enr.node_id)
        entry = bucket.get(enr.node_id)
        if entry is not None:
            if enr.seq >= entry.enr.seq:
                bucket[enr.node_id] = _BucketEntry(enr)
            return False
        if len(bucket) >= K_BUCKET_SIZE:
            # evict stalest entry (liveness-checked eviction is the ping
            # loop's job; here we keep the table bounded)
            stalest = min(bucket.values(), key=lambda e: e.last_seen)
            if time.monotonic() - stalest.last_seen < RECORD_TTL:
                return False
            del bucket[stalest.enr.node_id]
        bucket[enr.node_id] = _BucketEntry(enr)
        return True

    def remove(self, node_id: str) -> None:
        self._bucket_of(node_id).pop(node_id, None)

    def touch(self, node_id: str) -> None:
        entry = self._bucket_of(node_id).get(node_id)
        if entry is not None:
            entry.last_seen = time.monotonic()

    def closest(self, target_id: str, count: int = K_BUCKET_SIZE) -> list[ENR]:
        all_entries = [e.enr for b in self.buckets for e in b.values()]
        all_entries.sort(key=lambda e: _distance(target_id, e.node_id))
        return all_entries[:count]

    def all(self) -> list[ENR]:
        return [e.enr for b in self.buckets for e in b.values()]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)


class Discovery(asyncio.DatagramProtocol):
    """UDP discovery service; every packet is `node_id(20B hex=40) +
    sig(64) + type(1) + body`, signed over (type + body)."""

    def __init__(self, identity: NodeIdentity, enr: ENR):
        self.identity = identity
        self.local_enr = enr.sign(identity)
        self.table = RoutingTable(enr.node_id)
        self.transport_udp: asyncio.DatagramTransport | None = None
        self._pending_pong: dict[str, asyncio.Future] = {}
        # endpoint proof (anti-reflection): node_id -> addr that answered
        # OUR ping with a valid PONG (discv5 WHOAREYOU-equivalent role).
        # Bounded LRU: fresh signed identities are free to mint, so any
        # per-identity map an attacker can populate must cap — eviction
        # only costs the evicted peer one extra
        # challenge round-trip.
        self._endpoint_proven: "OrderedDict[str, tuple]" = OrderedDict()
        # live challenges: node_id -> (addr, issued_at monotonic); entries
        # expire after _CHALLENGE_TTL and the maps cap at _MAX_CHALLENGES
        self._ping_addr: dict[str, tuple] = {}
        # FINDNODEs held back until the challenge round-trip completes:
        # node_id -> (addr, target_id) — answered from the PONG handler
        self._pending_findnode: dict[str, tuple] = {}
        self._pending_nodes: dict[str, asyncio.Future] = {}
        # node_id → pubkey / highest-seen-nonce: same identity-minting
        # growth concern as _endpoint_proven, same bounded-LRU treatment
        self._known_keys: "OrderedDict[str, bytes]" = OrderedDict()
        self._last_nonce: "OrderedDict[str, int]" = OrderedDict()
        self._nonce = int(time.time() * 1000) << 16  # survives restarts
        # token bucket for challenge PINGs (each unproven FINDNODE reflects
        # one ~86B PING; bound the reflected bandwidth toward spoofed addrs)
        self._challenge_tokens = _CHALLENGE_PINGS_PER_SEC
        self._challenge_refill_t = time.monotonic()
        self._liveness_task: asyncio.Task | None = None
        self.on_discovered: list = []  # callbacks(enr)
        # optional beacon metrics bundle (network wiring sets it); every
        # increment is guarded so discovery runs identically unwired
        self.metrics = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        loop = asyncio.get_running_loop()
        self.transport_udp, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(host, port)
        )
        addr = self.transport_udp.get_extra_info("sockname")[:2]
        if self.local_enr.udp_port == 0:
            self.local_enr.udp_port = addr[1]
            self.local_enr.seq += 1
            self.local_enr.sign(self.identity)
        return addr

    def start_liveness_loop(self) -> None:
        """Periodically ping the stalest table entries; dead ones are
        evicted by ping()'s timeout path (discv5 liveness checks)."""
        self._liveness_task = asyncio.get_running_loop().create_task(
            self._liveness_loop()
        )

    async def _liveness_loop(self) -> None:
        while True:
            await asyncio.sleep(PING_INTERVAL)
            now = time.monotonic()
            stale = sorted(
                (
                    e
                    for b in self.table.buckets
                    for e in b.values()
                    if now - e.last_seen > PING_INTERVAL
                ),
                key=lambda e: e.last_seen,
            )[:4]
            for entry in stale:
                await self.ping(entry.enr)

    def stop(self) -> None:
        if self._liveness_task is not None:
            self._liveness_task.cancel()
        if self.transport_udp is not None:
            self.transport_udp.close()

    # -- packet plumbing -----------------------------------------------------

    def _send(self, addr, ptype: int, body: bytes) -> None:
        if self.transport_udp is None:
            return
        # monotonic per-sender nonce, covered by the signature: receivers
        # reject non-increasing nonces, so captured packets can't be
        # replayed to fake liveness or reflect NODES at victims
        # advance the clock component on every send (not just at startup):
        # receivers enforce a freshness window on the high 48 bits, so a
        # nonce pinned at process-start time would make every packet from
        # a >window-old process look stale and break discovery liveness
        self._nonce = max(self._nonce + 1, int(time.time() * 1000) << 16)
        content = struct.pack(">Q", self._nonce) + bytes([ptype]) + body
        sig = self.identity.sign(b"disc:" + content)
        packet = self.local_enr.node_id.encode() + sig + content
        if len(packet) <= MAX_PACKET:
            self.transport_udp.sendto(packet, addr)
            if self.metrics is not None:
                self.metrics.discv5_tx_total.inc(
                    type=_PTYPE_NAMES.get(ptype, str(ptype))
                )

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            node_id = data[:40].decode()
            sig, content = data[40:104], data[104:]
            (nonce,) = struct.unpack_from(">Q", content, 0)
            ptype, body = content[8], content[9:]
        except Exception:
            return
        if nonce <= self._last_nonce.get(node_id, 0):
            return  # replayed or reordered-stale packet
        # freshness window: the nonce's high 48 bits are the sender's
        # epoch-ms clock. Bounding _last_nonce (LRU) alone would re-enable
        # replay of a victim's captured packets once its entry is flooded
        # out; rejecting packets older than the window closes that hole for
        # anything but a <window-old capture racing an eviction flood —
        # consensus peers keep clocks within slot tolerance, so a generous
        # window costs nothing.
        if (nonce >> 16) < (time.time() - _NONCE_WINDOW_SEC) * 1000:
            return
        if self.metrics is not None:
            self.metrics.discv5_rx_total.inc(
                type=_PTYPE_NAMES.get(ptype, str(ptype))
            )
        asyncio.get_running_loop().create_task(
            self._handle(node_id, sig, nonce, ptype, body, addr, content)
        )

    async def _handle(
        self, node_id: str, sig: bytes, nonce: int, ptype: int, body: bytes, addr, content: bytes
    ):
        # Authentication: PING carries the sender's ENR (with pubkey);
        # other packets must come from a node whose key we've learned.
        try:
            if ptype == _PING:
                enr, _ = ENR.decode(body)
                if enr.node_id != node_id or not enr.verify():
                    return
                if not verify_identity(enr.pubkey, sig, b"disc:" + content):
                    return
                _lru_put(self._last_nonce, node_id, nonce, _KEYS_MAX)
                _lru_put(self._known_keys, node_id, enr.pubkey, _KEYS_MAX)
                if self.table.update(enr):
                    self._notify(enr)
                self.table.touch(node_id)
                self._send(addr, _PONG, self.local_enr.encode())
                return

            pubkey = self._pubkey_for(node_id)
            if pubkey is None or not verify_identity(
                pubkey, sig, b"disc:" + content
            ):
                return
            _lru_put(self._last_nonce, node_id, nonce, _KEYS_MAX)
            self.table.touch(node_id)

            if ptype == _PONG:
                enr, _ = ENR.decode(body)
                if enr.node_id == node_id and enr.verify():
                    if self.table.update(enr):
                        self._notify(enr)
                # endpoint proof: a valid PONG from the address we PINGed
                # demonstrates the peer actually RECEIVES at that address
                # (a spoofed source cannot complete the round trip).
                # addr[:2]: IPv6 recvfrom yields 4-tuples; compare host+port.
                entry = self._ping_addr.get(node_id)
                if entry is not None and tuple(addr)[:2] == tuple(entry[0])[:2]:
                    del self._ping_addr[node_id]  # pop ONLY on match: a
                    # concurrent ping must not destroy a live challenge
                    _lru_put(
                        self._endpoint_proven, node_id, tuple(addr)[:2], _PROVEN_MAX
                    )
                    held = self._pending_findnode.pop(node_id, None)
                    if held is not None:
                        self._answer_findnode(held[0], held[1])
                fut = self._pending_pong.pop(node_id, None)
                if fut is not None and not fut.done():
                    fut.set_result(True)
            elif ptype == _FINDNODE:
                target = body[:40].decode()
                proven = self._endpoint_proven.get(node_id)
                if proven == tuple(addr)[:2]:
                    self._endpoint_proven.move_to_end(node_id)  # keep hot
                    self._answer_findnode(tuple(addr)[:2], target)
                    return
                # unproven source address: a ~49B FINDNODE must not
                # reflect a ~1.2KB NODES at a spoofed victim. Hold the query, run the proof
                # round-trip (our PING -> their PONG), and the PONG
                # handler answers it — the querier's single in-flight
                # lookup still completes (just one RTT later).
                now = time.monotonic()
                self._gc_challenges(now)
                live = self._ping_addr.get(node_id)
                if live is not None:
                    # challenge already in flight for this identity: refresh
                    # the held query, never issue a second PING (per-identity
                    # amplification would defeat the rate limit)
                    if tuple(addr)[:2] == tuple(live[0])[:2]:
                        self._pending_findnode[node_id] = (tuple(addr)[:2], target)
                    return
                if len(self._ping_addr) >= _MAX_CHALLENGES:
                    if self.metrics is not None:
                        self.metrics.discv5_challenge_drops_total.inc()
                    return  # full table of live challenges: shed load
                self._challenge_tokens = min(
                    _CHALLENGE_PINGS_PER_SEC,
                    self._challenge_tokens
                    + (now - self._challenge_refill_t) * _CHALLENGE_PINGS_PER_SEC,
                )
                self._challenge_refill_t = now
                if self._challenge_tokens < 1.0:
                    if self.metrics is not None:
                        self.metrics.discv5_challenge_drops_total.inc()
                    return  # over the global challenge-PING budget
                self._challenge_tokens -= 1.0
                self._pending_findnode[node_id] = (tuple(addr)[:2], target)
                self._ping_addr[node_id] = (tuple(addr)[:2], now)
                self._send(addr, _PING, self.local_enr.encode())
            elif ptype == _NODES:
                count = body[0]
                offset = 1
                enrs = []
                for _ in range(min(count, K_BUCKET_SIZE)):
                    enr, offset = ENR.decode(body, offset)
                    if enr.verify():
                        enrs.append(enr)
                        # record the key: packets from relayed peers must be
                        # verifiable, or multi-hop discovery can't converge
                        _lru_put(self._known_keys, enr.node_id, enr.pubkey, _KEYS_MAX)
                        if self.table.update(enr):
                            self._notify(enr)
                fut = self._pending_nodes.pop(node_id, None)
                if fut is not None and not fut.done():
                    fut.set_result(enrs)
        except Exception as e:  # malformed packet — drop
            log.debug(f"discovery packet error from {node_id[:8]}: {e}")

    def _gc_challenges(self, now: float) -> None:
        """Expire stale challenge state; held FINDNODEs die with their
        challenge (the querier simply retries)."""
        expired = [
            nid
            for nid, (_, t) in self._ping_addr.items()
            if now - t > _CHALLENGE_TTL
        ]
        for nid in expired:
            self._ping_addr.pop(nid, None)
            self._pending_findnode.pop(nid, None)

    def _answer_findnode(self, addr, target: str) -> None:
        closest = self.table.closest(target, K_BUCKET_SIZE)
        out = bytearray()
        count = 0
        for enr in closest:
            encoded = enr.encode()
            if len(out) + len(encoded) > MAX_PACKET - 120:
                break
            out += encoded
            count += 1
        self._send(addr, _NODES, bytes([count]) + bytes(out))

    def _pubkey_for(self, node_id: str) -> bytes | None:
        """Sender key for packet auth: the learned-keys map, else the
        signature-verified table record."""
        pubkey = self._known_keys.get(node_id)
        if pubkey is not None:
            return pubkey
        for enr in self.table.all():
            if enr.node_id == node_id:
                _lru_put(self._known_keys, node_id, enr.pubkey, _KEYS_MAX)
                return enr.pubkey
        return None

    def _notify(self, enr: ENR) -> None:
        for cb in self.on_discovered:
            try:
                cb(enr)
            except Exception:
                log.warning("discovery callback failed", exc_info=True)

    # -- protocol ops --------------------------------------------------------

    async def ping(self, enr: ENR, timeout: float = 2.0) -> bool:
        fut = asyncio.get_running_loop().create_future()
        self._pending_pong[enr.node_id] = fut
        self._ping_addr[enr.node_id] = ((enr.ip, enr.udp_port), time.monotonic())
        self._send((enr.ip, enr.udp_port), _PING, self.local_enr.encode())
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            self.table.remove(enr.node_id)
            if self.metrics is not None:
                self.metrics.discv5_liveness_evictions_total.inc()
            return False
        finally:
            # a stale future must not swallow a later request's response
            if self._pending_pong.get(enr.node_id) is fut:
                del self._pending_pong[enr.node_id]

    async def find_node(self, enr: ENR, target_id: str, timeout: float = 2.0) -> list[ENR]:
        fut = asyncio.get_running_loop().create_future()
        self._pending_nodes[enr.node_id] = fut
        self._send((enr.ip, enr.udp_port), _FINDNODE, target_id.encode())
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return []
        finally:
            if self._pending_nodes.get(enr.node_id) is fut:
                del self._pending_nodes[enr.node_id]

    async def bootstrap(self, bootnodes: list[ENR]) -> None:
        for enr in bootnodes:
            if not enr.verify() or enr.node_id == self.local_enr.node_id:
                continue
            _lru_put(self._known_keys, enr.node_id, enr.pubkey, _KEYS_MAX)
            if self.table.update(enr):
                self._notify(enr)
            await self.ping(enr)
        await self.lookup(self.local_enr.node_id)

    async def lookup(self, target_id: str) -> list[ENR]:
        """Iterative Kademlia lookup: query ALPHA closest, absorb NODES
        (inserted by the receive path), repeat until the closest-known
        distance stops improving."""
        if self.metrics is not None:
            self.metrics.discv5_lookups_total.inc()
        queried: set[str] = set()

        def best() -> int:
            closest = self.table.closest(target_id, 1)
            return _distance(target_id, closest[0].node_id) if closest else 1 << 256

        while True:
            candidates = [
                e for e in self.table.closest(target_id, K_BUCKET_SIZE)
                if e.node_id not in queried
            ][:ALPHA]
            if not candidates:
                break
            before = best()
            results = await asyncio.gather(
                *(self.find_node(e, target_id) for e in candidates)
            )
            queried.update(e.node_id for e in candidates)
            if not any(results) or best() >= before:
                break
        return self.table.closest(target_id, K_BUCKET_SIZE)

    # -- consumer queries ----------------------------------------------------

    def find_peers_for_subnet(self, subnet: int) -> list[ENR]:
        """Peers advertising the attnet (reference subnet-targeted query)."""
        return [e for e in self.table.all() if e.has_attnet(subnet)]

    def update_attnets(self, bits: list[bool]) -> None:
        """Refresh the local ENR's attnets bitfield (reference:
        AttnetsService updating the ENR on subscription changes)."""
        value = 0
        for i, b in enumerate(bits):
            if b:
                value |= 1 << i
        if value != self.local_enr.attnets:
            self.local_enr.attnets = value
            self.local_enr.seq += 1
            self.local_enr.sign(self.identity)


def enr_to_text(enr: ENR) -> str:
    """Shareable one-line record (role of the base64 `enr:` text form)."""
    import base64

    return "enr-tpu:" + base64.urlsafe_b64encode(enr.encode()).decode().rstrip("=")


def enr_from_text(text: str) -> ENR:
    import base64

    if not text.startswith("enr-tpu:"):
        raise ValueError("not an enr-tpu record")
    raw = text[len("enr-tpu:"):]
    raw += "=" * (-len(raw) % 4)
    enr, _ = ENR.decode(base64.urlsafe_b64decode(raw))
    if not enr.verify():
        raise ValueError("invalid record signature")
    return enr
