"""Byte helpers (hex, int encodings): the port's copy of the JAX package's
`utils/bytes.py`, after the reference's `packages/utils/src/bytes.ts`.
Consensus integers are little-endian uint64.
"""

from __future__ import annotations


def to_hex(data: bytes) -> str:
    return "0x" + data.hex()


def from_hex(hex_str: str) -> bytes:
    return bytes.fromhex(hex_str[2:] if hex_str.startswith("0x") else hex_str)


def int_to_bytes(value: int, length: int, byteorder: str = "little") -> bytes:
    return int(value).to_bytes(length, byteorder)  # type: ignore[arg-type]


def bytes_to_int(data: bytes, byteorder: str = "little") -> int:
    return int.from_bytes(data, byteorder)  # type: ignore[arg-type]


def uint64_to_bytes(value: int) -> bytes:
    return int(value).to_bytes(8, "little")


def bytes32_rjust(data: bytes) -> bytes:
    """Right-pad to 32 bytes (SSZ chunk padding)."""
    if len(data) > 32:
        raise ValueError(f"data longer than 32 bytes: {len(data)}")
    return data + b"\x00" * (32 - len(data))


def xor_bytes(a: bytes, b: bytes) -> bytes:
    if len(a) != len(b):
        raise ValueError("xor length mismatch")
    return bytes(x ^ y for x, y in zip(a, b))
