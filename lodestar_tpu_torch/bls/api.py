"""The verifier's input types: the hash-to-curve domain and a signature set.

`TorchBlsVerifier` duck-types its sets as `s.pubkey.to_bytes()` (48 B
compressed G1), `s.message` (32 B signing root) and `s.signature` (96 B
compressed G2), so the JAX package's `SignatureSet` objects work as well.
"""

from __future__ import annotations

from dataclasses import dataclass

# RFC 9380 domain separation tag of the Ethereum consensus signatures
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


@dataclass(frozen=True)
class PublicKey:
    """A compressed G1 public key (48 bytes, not validated here)."""

    data: bytes

    def to_bytes(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class SignatureSet:
    """One verification work item: a (pre-aggregated) public key, a signing
    root and a compressed signature."""

    pubkey: PublicKey
    message: bytes
    signature: bytes
