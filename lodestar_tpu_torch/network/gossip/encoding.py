"""Gossip message encoding + message-id functions.

Reference: `network/gossip/encoding.ts` — payloads are snappy-compressed
SSZ (`DataTransformSnappy`); `fastMsgIdFn` = xxhash64 of the raw wire data
(cheap de-dup key, :12); `msgIdFn` = SHA256(domain + topic-len + topic +
uncompressed)[:20] per the altair p2p spec (:21-50), with the
MESSAGE_DOMAIN_VALID/INVALID_SNAPPY split for undecodable payloads.
Codecs are the C host tier (`native`).

(The port's copy of the JAX package's `network/gossip/encoding.py`.)
"""

from __future__ import annotations

from ... import native
from ...ssz.hashing import sha256

MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"
MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
GOSSIP_MSGID_LENGTH = 20
MAX_GOSSIP_SIZE = 10 * 2**20


def encode_message(ssz_bytes: bytes) -> bytes:
    return native.snappy_compress(ssz_bytes)


def decode_message(wire: bytes) -> bytes:
    if len(wire) > MAX_GOSSIP_SIZE:
        raise ValueError("gossip message too large")
    return native.snappy_uncompress(wire)


def fast_msg_id(wire: bytes) -> int:
    """Cheap pre-filter id for the seen-cache (xxhash64 of compressed
    data)."""
    return native.xxh64(wire)


def compute_msg_id(topic: str, wire: bytes) -> bytes:
    """Canonical gossip message-id (altair p2p spec): sha256 over domain +
    uint64-le topic length + topic + (un)compressed payload, first 20B."""
    topic_bytes = topic.encode()
    prefix = len(topic_bytes).to_bytes(8, "little")
    try:
        payload = native.snappy_uncompress(wire)
        domain = MESSAGE_DOMAIN_VALID_SNAPPY
    except ValueError:
        payload = wire
        domain = MESSAGE_DOMAIN_INVALID_SNAPPY
    return sha256(domain + prefix + topic_bytes + payload)[:GOSSIP_MSGID_LENGTH]
