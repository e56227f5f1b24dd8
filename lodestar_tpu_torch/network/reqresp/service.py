"""Req/Resp over live transport streams.

Reference: `network/reqresp/reqResp.ts` — per-protocol dial/respond over
libp2p streams with TTFB/RESP timeouts, response-time peer scoring and a
served-request rate tracker (`reqresp/rateTracker.ts`,
`reqresp/score.ts`). This module binds the transport (stream layer), the
wire codec (`codec.py`), and the server handlers (`handlers.py`).

The client surface is async; `RemotePeer` adapts it to the synchronous
`IPeer` protocol the sync layer consumes (via the owning loop), keeping
sync logic transport-agnostic.

(The port's copy of the JAX package's `network/reqresp/service.py`.)
"""

from __future__ import annotations

import logging
import asyncio
import time
from dataclasses import dataclass, field

from ..peers import PeerAction
from .codec import (
    RespCode,
    decode_request,
    decode_response_chunks,
    encode_error_chunk,
    encode_request,
)
from .protocols import Protocol, parse_protocol_id, protocol_id

TTFB_TIMEOUT = 5.0  # time-to-first-byte (reference constants.ts)
RESP_TIMEOUT = 10.0
REQUEST_TIMEOUT = 5.0

log = logging.getLogger(__name__)


class RequestError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}")
        self.code = code


@dataclass
class RateTracker:
    """Sliding-window served-objects quota (reference rateTracker.ts)."""

    limit: int = 500
    window_sec: float = 60.0
    _events: list[tuple[float, int]] = field(default_factory=list)

    def request_objects(self, count: int, now: float | None = None) -> int:
        """Returns objects granted (0 when over quota)."""
        now = time.monotonic() if now is None else now
        cutoff = now - self.window_sec
        self._events = [(t, c) for t, c in self._events if t > cutoff]
        used = sum(c for _, c in self._events)
        if used + count > self.limit:
            return 0
        self._events.append((now, count))
        return count


class ReqRespService:
    """Server dispatch + typed async client calls for every protocol."""

    def __init__(self, transport, handlers, types, peer_manager=None, metrics=None):
        self.transport = transport
        self.handlers = handlers
        self.types = types
        self.peer_manager = peer_manager
        self.metrics = metrics
        self.block_rate = RateTracker(limit=2000)
        self.request_rate = RateTracker(limit=50, window_sec=10.0)
        transport.set_prefix_handler("/eth2/beacon_chain/req/", self._on_stream)

    # ------------------------------------------------------------------ server

    async def _on_stream(self, stream) -> None:
        try:
            proto, _version = parse_protocol_id(stream.protocol)
        except ValueError:
            await stream.reset()
            return
        peer_id = stream.conn.peer_id
        self._hook("incoming_request", proto.value)
        if self.request_rate.request_objects(1) == 0:
            self._hook("rate_limited", "requests")
            await stream.write(encode_error_chunk(RespCode.RESOURCE_UNAVAILABLE, "rate limit"))
            await stream.close()
            self._penalize(peer_id, PeerAction.MidToleranceError)
            return
        try:
            wire_req = await asyncio.wait_for(
                self._read_request_capped(stream), REQUEST_TIMEOUT
            )
            response = self._respond(proto, wire_req)
        except Exception as e:  # malformed request
            log.debug(f"reqresp {proto.value} from {peer_id[:8]} failed: {e}")
            response = encode_error_chunk(RespCode.INVALID_REQUEST, str(e)[:64])
            self._penalize(peer_id, PeerAction.LowToleranceError)
            self._hook("incoming_error", proto.value)
        self._hook("bytes_sent", proto.value, len(response))
        try:
            await stream.write(response)
            await stream.close()
        except Exception as e:
            # peer hung up mid-response; scoring already recorded the event
            log.debug("response write to %s failed: %s", peer_id, e)

    # requests are tiny (Status=84B SSZ, ByRoot ≤ 32KiB of roots); anything
    # bigger is hostile — cap buffering so a frame-pumping peer can't balloon
    # server memory inside the request timeout
    MAX_REQUEST_WIRE = 256 * 1024

    async def _read_request_capped(self, stream) -> bytes:
        chunks: list[bytes] = []
        total = 0
        while True:
            chunk = await stream.read()
            if chunk is None:
                return b"".join(chunks)
            total += len(chunk)
            if total > self.MAX_REQUEST_WIRE:
                raise ValueError("request exceeds size cap")
            chunks.append(chunk)

    def _respond(self, proto: Protocol, wire_req: bytes) -> bytes:
        h = self.handlers
        if proto is Protocol.Status:
            return h.on_status(self.types.Status.deserialize(decode_request(wire_req)))
        if proto is Protocol.Goodbye:
            return h.on_goodbye(int.from_bytes(decode_request(wire_req)[:8], "little"))
        if proto is Protocol.Ping:
            return h.on_ping(int.from_bytes(decode_request(wire_req)[:8], "little"))
        if proto is Protocol.Metadata:
            return h.on_metadata(None)
        if proto is Protocol.BeaconBlocksByRange:
            raw = decode_request(wire_req)
            start_slot = int.from_bytes(raw[0:8], "little")
            count = int.from_bytes(raw[8:16], "little")
            granted = self.block_rate.request_objects(min(count, 1024))
            if granted == 0:
                self._hook("rate_limited", "blocks")
                return encode_error_chunk(RespCode.RESOURCE_UNAVAILABLE, "rate limit")
            return h.on_beacon_blocks_by_range(start_slot, count)
        if proto is Protocol.BeaconBlocksByRoot:
            raw = decode_request(wire_req)
            roots = [raw[i : i + 32] for i in range(0, len(raw), 32)]
            granted = self.block_rate.request_objects(max(1, len(roots)))
            if granted == 0:
                self._hook("rate_limited", "blocks")
                return encode_error_chunk(RespCode.RESOURCE_UNAVAILABLE, "rate limit")
            return h.on_beacon_blocks_by_root(roots)
        if proto is Protocol.LightClientBootstrap:
            return h.on_light_client_bootstrap(decode_request(wire_req))
        if proto is Protocol.LightClientUpdatesByRange:
            raw = decode_request(wire_req)
            start = int.from_bytes(raw[0:8], "little")
            count = int.from_bytes(raw[8:16], "little")
            return h.on_light_client_updates_by_range(start, count)
        if proto is Protocol.LightClientFinalityUpdate:
            return h.on_light_client_finality_update()
        if proto is Protocol.LightClientOptimisticUpdate:
            return h.on_light_client_optimistic_update()
        return encode_error_chunk(RespCode.SERVER_ERROR, "unhandled protocol")

    def _penalize(self, peer_id: str, action: PeerAction) -> None:
        if self.peer_manager is not None:
            self.peer_manager.report_peer(peer_id, action)

    def _hook(self, name: str, *args) -> None:
        fn = getattr(self.metrics, name, None)
        if fn is not None:
            fn(*args)

    # ------------------------------------------------------------------ client

    async def _request_raw(
        self, peer_id: str, proto: Protocol, version: int, req_ssz: bytes | None
    ) -> list[tuple[RespCode, bytes]]:
        conn = self.transport.connections.get(peer_id)
        if conn is None:
            raise RequestError("DIAL_ERROR", f"no connection to {peer_id[:8]}")
        self._hook("outgoing_request", proto.value)
        t0 = time.monotonic()
        stream = await conn.open_stream(protocol_id(proto, version))
        try:
            if req_ssz is not None:
                await stream.write(encode_request(req_ssz))
            await stream.close()
            first = await stream.read(timeout=TTFB_TIMEOUT)
            if first is None:
                raise RequestError("EMPTY_RESPONSE")
            rest = await asyncio.wait_for(stream.read_all(), RESP_TIMEOUT)
        except (TimeoutError, asyncio.TimeoutError):
            # asyncio.TimeoutError is a distinct class until 3.11
            self._penalize(peer_id, PeerAction.HighToleranceError)
            self._hook("outgoing_error", proto.value)
            raise RequestError("RESP_TIMEOUT", proto.value) from None
        finally:
            await stream.reset()
        observe = getattr(self.metrics, "observe_reqresp", None)
        if observe is not None:
            observe(proto.value, time.monotonic() - t0)
        self._hook("bytes_received", proto.value, len(first) + len(rest))
        chunks = decode_response_chunks(first + rest)
        for code, payload in chunks:
            self._hook("response_chunk", code.name)
            if code != RespCode.SUCCESS:
                self._hook("outgoing_error", proto.value)
                raise RequestError(code.name, payload[:64].decode(errors="replace"))
        return chunks

    async def status(self, peer_id: str, local_status=None):
        local = local_status or self.handlers.local_status()
        chunks = await self._request_raw(peer_id, Protocol.Status, 1, local.serialize())
        return self.types.Status.deserialize(chunks[0][1])

    async def goodbye(self, peer_id: str, reason: int = 0) -> None:
        try:
            await self._request_raw(
                peer_id, Protocol.Goodbye, 1, reason.to_bytes(8, "little")
            )
        except RequestError:
            pass  # goodbye is best-effort

    async def ping(self, peer_id: str, seq: int = 0) -> int:
        chunks = await self._request_raw(peer_id, Protocol.Ping, 1, seq.to_bytes(8, "little"))
        return int.from_bytes(chunks[0][1][:8], "little")

    async def metadata(self, peer_id: str):
        chunks = await self._request_raw(peer_id, Protocol.Metadata, 2, None)
        return self.types.Metadata.deserialize(chunks[0][1])

    async def beacon_blocks_by_range(self, peer_id: str, start_slot: int, count: int, step: int = 1):
        req = (
            start_slot.to_bytes(8, "little")
            + count.to_bytes(8, "little")
            + step.to_bytes(8, "little")
        )
        chunks = await self._request_raw(peer_id, Protocol.BeaconBlocksByRange, 2, req)
        return [self.types.SignedBeaconBlock.deserialize(p) for _, p in chunks]

    async def beacon_blocks_by_root(self, peer_id: str, roots: list[bytes]):
        chunks = await self._request_raw(
            peer_id, Protocol.BeaconBlocksByRoot, 2, b"".join(roots)
        )
        return [self.types.SignedBeaconBlock.deserialize(p) for _, p in chunks]


class RemotePeer:
    """Synchronous `IPeer` view of a remote peer for the sync layer.

    Sync's download loop is synchronous rounds; each call submits the
    coroutine to the network's event loop and blocks the calling (worker)
    thread on the result — mirroring how the reference sync awaits
    reqresp promises."""

    def __init__(self, service: ReqRespService, peer_id: str, loop: asyncio.AbstractEventLoop):
        self.service = service
        self.peer_id = peer_id
        self.loop = loop

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=30.0)

    def status(self):
        return self._run(self.service.status(self.peer_id))

    def beacon_blocks_by_range(self, start_slot: int, count: int) -> list:
        return self._run(
            self.service.beacon_blocks_by_range(self.peer_id, start_slot, count)
        )

    def beacon_blocks_by_root(self, roots: list[bytes]) -> list:
        return self._run(self.service.beacon_blocks_by_root(self.peer_id, roots))
