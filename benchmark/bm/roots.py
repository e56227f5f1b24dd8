"""Signing roots of the consensus objects the cells sign, by SSZ's
hash_tree_root and the specification's compute_signing_root, with
`hashlib` alone (no consensus library)."""

from __future__ import annotations

import hashlib


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _uint64(v: int) -> bytes:
    return v.to_bytes(8, "little") + b"\x00" * 24


def merkleize(chunks: list[bytes]) -> bytes:
    """The root of 32-byte chunks padded with zero chunks to a power of two."""
    n = 1
    while n < len(chunks):
        n *= 2
    level = chunks + [b"\x00" * 32] * (n - len(chunks))
    while len(level) > 1:
        level = [_h(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


def checkpoint_root(epoch: int, root: bytes) -> bytes:
    return merkleize([_uint64(epoch), root])


def attestation_data_root(slot: int, index: int, head: bytes, source: tuple, target: tuple) -> bytes:
    return merkleize([_uint64(slot), _uint64(index), head, checkpoint_root(*source),
                      checkpoint_root(*target)])


def block_header_root(slot: int, proposer: int, parent: bytes, state: bytes, body: bytes) -> bytes:
    return merkleize([_uint64(slot), _uint64(proposer), parent, state, body])


def epoch_root(epoch: int) -> bytes:
    return _uint64(epoch)


def compute_domain(domain_type: bytes, fork_version: bytes, genesis_validators_root: bytes) -> bytes:
    fork_data_root = merkleize([fork_version + b"\x00" * 28, genesis_validators_root])
    return domain_type + fork_data_root[:28]


def signing_root(object_root: bytes, domain: bytes) -> bytes:
    return merkleize([object_root, domain])
