"""Peer abstraction for sync: the req/resp client surface.

`LocalPeer` wires two in-process nodes through the REAL wire codec
(encode_request → handler → decode_response_chunks), so sync tests
exercise the same bytes a network transport would carry (reference analog:
e2e tests with real libp2p between local nodes, SURVEY.md §4.4)."""

from __future__ import annotations

from typing import Protocol

from ..network.reqresp import (
    RespCode,
    decode_response_chunks,
)


class IPeer(Protocol):
    """A sync-usable remote peer.

    Implementations MUST tolerate concurrent request calls (serialize
    internally, as LocalPeer does): RangeSync's download window and
    BackfillSync may both issue requests to the same peer from
    different threads, and a transport multiplexing one stream per
    peer would otherwise interleave request frames."""

    peer_id: str

    def status(self): ...
    def beacon_blocks_by_range(self, start_slot: int, count: int) -> list: ...
    def beacon_blocks_by_root(self, roots: list[bytes]) -> list: ...


class PeerError(Exception):
    pass


class LocalPeer:
    """A peer backed by another node's ReqRespHandlers (same process).

    Requests serialize on an internal lock — the IPeer contract — so
    RangeSync's download window and BackfillSync can hit the same peer
    from different threads without interleaving."""

    def __init__(self, peer_id: str, handlers, types):
        import threading

        self.peer_id = peer_id
        self.handlers = handlers
        self.types = types
        self._lock = threading.Lock()

    def status(self):
        with self._lock:
            wire = self.handlers.on_status(None)
        chunks = decode_response_chunks(wire)
        self._check(chunks)
        return self.types.Status.deserialize(chunks[0][1])

    def beacon_blocks_by_range(self, start_slot: int, count: int) -> list:
        with self._lock:
            wire = self.handlers.on_beacon_blocks_by_range(start_slot, count)
        chunks = decode_response_chunks(wire)
        self._check(chunks)
        return [self.types.SignedBeaconBlock.deserialize(p) for _, p in chunks]

    def beacon_blocks_by_root(self, roots: list[bytes]) -> list:
        with self._lock:
            wire = self.handlers.on_beacon_blocks_by_root(roots)
        chunks = decode_response_chunks(wire)
        self._check(chunks)
        return [self.types.SignedBeaconBlock.deserialize(p) for _, p in chunks]

    @staticmethod
    def _check(chunks) -> None:
        for code, payload in chunks:
            if code != RespCode.SUCCESS:
                raise PeerError(f"{code.name}: {payload[:64]!r}")
