"""The BLS signature API over the C host tier, and the verifier's set type.

The port's counterpart of `lodestar_tpu/bls/api.py` (ciphersuite
BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_): the same names and the same
bytes in and out, with every operation in `native/` (the C host tier)
instead of the JAX package's Python oracle. Keys and signatures are held
compressed (48 B G1, 96 B G2); a point is parsed only where an operation
needs it. Every public name of the JAX module is here
(`aggregate_verify` is one C entry, `lodestar_bls_aggregate_verify`).

`TorchBlsVerifier` duck-types its sets as `s.pubkey.to_bytes()` (48 B
compressed G1), `s.message` (32 B signing root) and `s.signature` (96 B
compressed G2), so the JAX package's `SignatureSet` objects work as well.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

# RFC 9380 domain separation tag of the Ethereum consensus signatures
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
CURVE_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


class BlsError(ValueError):
    pass


def _native():
    from .. import native

    return native


@dataclass(frozen=True)
class SecretKey:
    value: int

    def __post_init__(self):
        if not 0 < self.value < CURVE_ORDER:
            raise BlsError("secret key out of range")

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        """The big-endian 32-byte scalar (EIP-2335's keystore secret)."""
        if len(data) != 32:
            raise BlsError("secret key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    def to_bytes(self) -> bytes:
        return self.value.to_bytes(32, "big")

    def to_public_key(self) -> "PublicKey":
        rc, pk = _native().sk_to_pk(self.to_bytes())
        if rc != 0:
            raise BlsError(f"sk_to_pk failed ({rc})")
        return PublicKey(pk)

    def sign(self, message: bytes, dst: bytes = DST_G2) -> "Signature":
        rc, sig = _native().sign(self.to_bytes(), message, dst)
        if rc != 0:
            raise BlsError(f"sign failed ({rc})")
        return Signature(sig)


@dataclass(frozen=True)
class PublicKey:
    """A compressed G1 public key (48 bytes)."""

    data: bytes

    @classmethod
    def from_bytes(cls, data: bytes, validate: bool = True) -> "PublicKey":
        """With `validate`, KeyValidate: the key decompresses, is not
        infinity and lies in G1 (`g1_decompress(check_subgroup=True)`).
        Without it the bytes are kept as they are; the verifier refuses a
        malformed key when it decompresses it."""
        data = bytes(data)
        if len(data) != 48:
            raise BlsError("pubkey must be 48 bytes")
        if validate:
            rc, _ = _native().g1_decompress(data, check_subgroup=True)
            if rc == 1:
                raise BlsError("pubkey is point at infinity")
            if rc == -3:
                raise BlsError("pubkey not in G1 subgroup")
            if rc != 0:
                raise BlsError(f"malformed pubkey ({rc})")
        return cls(data)

    def to_bytes(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class Signature:
    """A compressed G2 signature (96 bytes)."""

    data: bytes

    @classmethod
    def from_bytes(cls, data: bytes, validate: bool = True) -> "Signature":
        """The signature must decompress onto the curve; with `validate` a
        point other than infinity must also lie in G2."""
        data = bytes(data)
        if len(data) != 96:
            raise BlsError("signature must be 96 bytes")
        rc, _ = _native().g2_decompress(data, check_subgroup=validate)
        if rc == -3:
            raise BlsError("signature not in G2 subgroup")
        if rc < 0:
            raise BlsError(f"malformed signature ({rc})")
        return cls(data)

    def to_bytes(self) -> bytes:
        return self.data


def aggregate_pubkeys(pubkeys: list[PublicKey]) -> PublicKey:
    """G1 sum of the keys, compressed, in one C call (no subgroup checks:
    keys are KeyValidated where they enter)."""
    if not pubkeys:
        raise BlsError("cannot aggregate empty pubkey list")
    rc, out = _native().g1_aggregate(b"".join(pk.to_bytes() for pk in pubkeys))
    if rc < 0:
        raise BlsError(f"malformed pubkey in aggregate ({rc})")
    return PublicKey(out)


def aggregate_signatures(signatures: list[Signature]) -> Signature:
    """G2 sum of the signatures, compressed, in one C call."""
    if not signatures:
        raise BlsError("cannot aggregate empty signature list")
    rc, out = _native().g2_aggregate(b"".join(s.to_bytes() for s in signatures))
    if rc < 0:
        raise BlsError(f"malformed signature in aggregate ({rc})")
    return Signature(out)


def verify(pubkey: PublicKey, message: bytes, signature: Signature, dst: bytes = DST_G2) -> bool:
    """CoreVerify on the C tier: e(pk, H(m)) · e(−g1, sig) == 1, with the
    key's and the signature's subgroup checks. An infinity key or
    signature gives False."""
    return _native().verify_sets(pubkey.to_bytes(), [message], signature.to_bytes(), dst)[0]


def fast_aggregate_verify(
    pubkeys: list[PublicKey], message: bytes, signature: Signature, dst: bytes = DST_G2
) -> bool:
    """All keys sign one message: verify against their aggregate."""
    if not pubkeys:
        return False
    return verify(aggregate_pubkeys(pubkeys), message, signature, dst)


def aggregate_verify(
    pubkeys: list[PublicKey], messages: list[bytes], signature: Signature, dst: bytes = DST_G2
) -> bool:
    """AggregateVerify: key i signed message i, one signature for all:
    Π e(pkᵢ, H(mᵢ)) · e(−g1, sig) == 1 in one C call (one Miller loop per
    pair, one final exponentiation). False on an empty list, a length
    mismatch, an infinity key or an infinity signature."""
    if not pubkeys or len(pubkeys) != len(messages):
        return False
    return _native().aggregate_verify(b"".join(pk.to_bytes() for pk in pubkeys),
                                      [bytes(m) for m in messages], signature.to_bytes(), dst)


def verify_signature_sets(sets: list["SignatureSet"]) -> bool:
    """True when every set verifies: all-or-nothing over the C tier's
    per-set verdicts (`native.verify_sets`), the verdict of the JAX
    module's random-linear-combination batch. False on an empty list or a
    set whose key or signature is infinity, malformed or outside its
    subgroup."""
    if not sets:
        return False
    try:
        return all(_native().verify_sets(
            b"".join(s.pubkey.to_bytes() for s in sets), [bytes(s.message) for s in sets],
            b"".join(bytes(s.signature) for s in sets), DST_G2))
    except ValueError:
        return False


def interop_secret_key(index: int) -> SecretKey:
    """Deterministic interop secret key i: int_le(sha256(uint256_le(i))) mod r."""
    h = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return SecretKey(int.from_bytes(h, "little") % CURVE_ORDER)


@dataclass(frozen=True)
class SignatureSet:
    """One verification work item: a (pre-aggregated) public key, a signing
    root and a compressed signature."""

    pubkey: PublicKey
    message: bytes
    signature: bytes
