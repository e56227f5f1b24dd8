"""Req/Resp wire codec: varint length prefix + snappy-framed SSZ.

Reference: `reqresp/encodingStrategies/sszSnappy/{encode,decode}.ts` and
response chunking (`response/` — <result byte><varint len><frames>).

(The port's copy of the JAX package's `network/reqresp/codec.py`.)
"""

from __future__ import annotations

from enum import IntEnum

from .snappy_frames import compress_frames, decompress_frames

MAX_VARINT_BYTES = 10
MAX_PAYLOAD = 10 * 2**20


class RespCode(IntEnum):
    SUCCESS = 0
    INVALID_REQUEST = 1
    SERVER_ERROR = 2
    RESOURCE_UNAVAILABLE = 3


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, offset: int) -> tuple[int, int]:
    value = 0
    shift = 0
    i = offset
    while i < len(data) and i - offset < MAX_VARINT_BYTES:
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, i
        shift += 7
    raise ValueError("truncated/oversized varint")


def encode_request(ssz_bytes: bytes) -> bytes:
    return _write_varint(len(ssz_bytes)) + compress_frames(ssz_bytes)


def decode_request(wire: bytes) -> bytes:
    declared, offset = _read_varint(wire, 0)
    if declared > MAX_PAYLOAD:
        raise ValueError("request too large")
    payload = decompress_frames(wire[offset:])
    if len(payload) != declared:
        raise ValueError("request length mismatch")
    return payload


def encode_response_chunk(ssz_bytes: bytes, code: RespCode = RespCode.SUCCESS) -> bytes:
    return bytes([code]) + _write_varint(len(ssz_bytes)) + compress_frames(ssz_bytes)


def encode_error_chunk(code: RespCode, message: str) -> bytes:
    msg = message.encode()[:256]
    return bytes([code]) + _write_varint(len(msg)) + compress_frames(msg)


def decode_response_chunks(wire: bytes) -> list[tuple[RespCode, bytes]]:
    """Split a response stream into (code, payload) chunks.

    The framing self-delimits: each chunk is result byte + varint + frames,
    and frames carry explicit lengths, so chunks can be walked without an
    outer transport framing."""
    out: list[tuple[RespCode, bytes]] = []
    i = 0
    while i < len(wire):
        code = RespCode(wire[i])
        declared, i = _read_varint(wire, i + 1)
        if declared > MAX_PAYLOAD:
            raise ValueError("chunk too large")
        payload, consumed = _decompress_frames_prefix(wire, i, declared)
        i = consumed
        if len(payload) != declared:
            raise ValueError("chunk length mismatch")
        out.append((code, payload))
    return out


def _decompress_frames_prefix(wire: bytes, offset: int, want: int) -> tuple[bytes, int]:
    """Decompress frames starting at `offset` until `want` bytes are
    produced; returns (payload, next offset)."""
    from .snappy_frames import (
        CHUNK_COMPRESSED,
        CHUNK_UNCOMPRESSED,
        STREAM_IDENTIFIER,
        _masked_checksum,
    )
    from ... import native

    if wire[offset : offset + len(STREAM_IDENTIFIER)] != STREAM_IDENTIFIER:
        raise ValueError("missing stream identifier")
    i = offset + len(STREAM_IDENTIFIER)
    out = bytearray()
    while len(out) < want or (want == 0 and len(out) == 0):
        if i + 4 > len(wire):
            raise ValueError("truncated frames")
        kind = wire[i]
        length = int.from_bytes(wire[i + 1 : i + 4], "little")
        i += 4
        body = wire[i : i + length]
        if len(body) < length:
            raise ValueError("truncated frame body")
        i += length
        if kind == 0xFF:
            continue
        if kind in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            checksum = int.from_bytes(body[:4], "little")
            payload = body[4:]
            if kind == CHUNK_COMPRESSED:
                payload = native.snappy_uncompress(payload)
            if _masked_checksum(payload) != checksum:
                raise ValueError("frame checksum mismatch")
            out += payload
            if want == 0:
                break
        elif kind >= 0x80:
            continue
        else:
            raise ValueError(f"unknown frame type {kind:#x}")
    return bytes(out), i
