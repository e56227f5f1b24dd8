"""Snappy *framing* format (streaming), used by req/resp payloads.

Reference: `reqresp/encodingStrategies/sszSnappy/` — the p2p spec requires
the framing format (not the block format gossip uses): a stream identifier
frame, then compressed/uncompressed data frames each carrying a masked
CRC32C of the uncompressed content. Inner compression reuses the native
block codec.

(The port's copy of the JAX package's `network/reqresp/snappy_frames.py`.)
"""

from __future__ import annotations

from ... import native

STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
CHUNK_COMPRESSED = 0x00
CHUNK_UNCOMPRESSED = 0x01
MAX_UNCOMPRESSED_CHUNK = 65536

# CRC32C (Castagnoli) table
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_checksum(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def compress_frames(data: bytes) -> bytes:
    """data → stream identifier + one frame per 64 KiB chunk."""
    out = bytearray(STREAM_IDENTIFIER)
    for i in range(0, max(len(data), 1), MAX_UNCOMPRESSED_CHUNK):
        chunk = data[i : i + MAX_UNCOMPRESSED_CHUNK]
        checksum = _masked_checksum(chunk)
        compressed = native.snappy_compress(chunk)
        if len(compressed) < len(chunk):
            body = checksum.to_bytes(4, "little") + compressed
            kind = CHUNK_COMPRESSED
        else:
            body = checksum.to_bytes(4, "little") + chunk
            kind = CHUNK_UNCOMPRESSED
        out.append(kind)
        out += len(body).to_bytes(3, "little")
        out += body
        if not data:
            break
    return bytes(out)


def decompress_frames(stream: bytes) -> bytes:
    """Frames → payload, verifying checksums; raises ValueError on corrupt
    input."""
    if not stream.startswith(STREAM_IDENTIFIER):
        raise ValueError("missing snappy stream identifier")
    i = len(STREAM_IDENTIFIER)
    out = bytearray()
    while i < len(stream):
        if i + 4 > len(stream):
            raise ValueError("truncated frame header")
        kind = stream[i]
        length = int.from_bytes(stream[i + 1 : i + 4], "little")
        i += 4
        if i + length > len(stream):
            raise ValueError("truncated frame body")
        body = stream[i : i + length]
        i += length
        if kind == 0xFF:  # repeated stream identifier
            continue
        if kind in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            if length < 4:
                raise ValueError("frame too short for checksum")
            checksum = int.from_bytes(body[:4], "little")
            payload = body[4:]
            if kind == CHUNK_COMPRESSED:
                payload = native.snappy_uncompress(payload)
            if _masked_checksum(payload) != checksum:
                raise ValueError("frame checksum mismatch")
            out += payload
        elif kind >= 0x80:  # reserved skippable
            continue
        else:
            raise ValueError(f"unknown frame type {kind:#x}")
    return bytes(out)
