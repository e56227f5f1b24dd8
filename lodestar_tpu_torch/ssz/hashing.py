"""SSZ hashing backend.

Equivalent role of `@chainsafe/as-sha256` (WASM) + `persistent-merkle-tree`
zero-hash machinery in the reference (SURVEY.md §2.3): SHA-256 pair hashing
with precomputed zero-subtree roots. The backend is pluggable: it is
hashlib by default, and `native.install_ssz_backend()` routes level
hashing to the C host tier's `lodestar_sha256_level` without touching
merkleization logic.
"""

from __future__ import annotations

from hashlib import sha256 as _sha256
from typing import Callable, List

HashFn = Callable[[bytes], bytes]


def sha256(data: bytes) -> bytes:
    return _sha256(data).digest()


def hash_pair(a: bytes, b: bytes) -> bytes:
    return _sha256(a + b).digest()


def hash_level(data: bytes) -> bytes:
    """Hash a concatenated level of 64-byte sibling pairs -> concatenated
    32-byte parents. `len(data)` must be a multiple of 64.

    This is the batch seam: a native backend can process all pairs at once.
    """
    n = len(data) // 64
    out = bytearray(32 * n)
    for i in range(n):
        out[32 * i : 32 * i + 32] = _sha256(data[64 * i : 64 * i + 64]).digest()
    return bytes(out)


# Backend slot — `native.install_ssz_backend()` replaces it.
_backend_hash_level = hash_level


def set_hash_backend(level_fn: Callable[[bytes], bytes]) -> None:
    global _backend_hash_level
    _backend_hash_level = level_fn


MAX_DEPTH = 64

# ZERO_HASHES[i] = root of a depth-i subtree of zero chunks
ZERO_HASHES: List[bytes] = [b"\x00" * 32]
for _ in range(MAX_DEPTH):
    ZERO_HASHES.append(hash_pair(ZERO_HASHES[-1], ZERO_HASHES[-1]))


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def merkleize_chunks(chunks: list[bytes] | bytes, limit: int | None = None) -> bytes:
    """Merkleize 32-byte chunks into a single root, virtually padding with
    zero chunks up to ``limit`` (or to the next power of two of the count).

    Matches the spec's `merkleize(chunks, limit)`. ``chunks`` may be a list of
    32-byte values or a single bytes blob whose length is a multiple of 32.
    """
    if isinstance(chunks, (bytes, bytearray)):
        data = bytes(chunks)
        count = len(data) // 32
    else:
        data = b"".join(chunks)
        count = len(chunks)

    size = limit if limit is not None else count
    if size < count:
        raise ValueError(f"chunk count {count} exceeds limit {limit}")
    if size == 0:
        return ZERO_HASHES[0]

    depth = (next_power_of_two(size) - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]

    level = data
    for d in range(depth):
        n = len(level) // 32
        if n % 2 == 1:
            level += ZERO_HASHES[d]
            n += 1
        level = _backend_hash_level(level)
    return level


def merkle_branch(chunks: list[bytes], index: int, limit: int | None = None) -> list[bytes]:
    """Sibling path for chunk `index` under the same padding rules as
    `merkleize_chunks` — bottom-up, `depth` elements. Verifiable with the
    standard is_valid_merkle_branch walk (the single-proof seam the
    light-client protocol needs; reference: persistent-merkle-tree proofs)."""
    count = len(chunks)
    size = limit if limit is not None else count
    depth = (next_power_of_two(max(size, 1)) - 1).bit_length()
    branch: list[bytes] = []
    level = list(chunks)
    idx = index
    for d in range(depth):
        if len(level) % 2 == 1:
            level.append(ZERO_HASHES[d])
        sibling = idx ^ 1
        branch.append(level[sibling] if sibling < len(level) else ZERO_HASHES[d])
        level = [
            hash_pair(level[i], level[i + 1]) for i in range(0, len(level), 2)
        ]
        idx //= 2
    return branch


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_pair(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_pair(root, selector.to_bytes(32, "little"))
