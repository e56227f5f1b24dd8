"""The network's own primitives: X25519 (RFC 7748), Ed25519 (RFC 8032),
HKDF-SHA256 (RFC 5869) and ChaCha20-Poly1305 (RFC 8439).

The JAX transport takes these from the `cryptography` wheel; the port
carries them, byte-equal to it, so a port node and a JAX node complete a
handshake with each other. X25519, Ed25519 and HKDF are Python integers
over `hashlib` and `hmac`: they run only at handshakes, record signing and
discovery packets. ChaCha20-Poly1305 seals every transport frame, so it is
C (`csrc/host/chacha20poly1305.c`, bound in `native`).

Ed25519 signatures are deterministic (RFC 8032 §5.1.6); a verification
checks S < L and compares the encoding of [S]B − [k]A with R, as
OpenSSL's does. The fixed-base multiplications run over a table of
4-bit windows of B built at first use.
"""

from __future__ import annotations

import hashlib
import hmac

from .. import native

# ---------------------------------------------------------------------------
# field and curve constants

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_A24 = 121665


class InvalidTag(Exception):
    """A ChaCha20-Poly1305 tag did not verify."""


# ---------------------------------------------------------------------------
# X25519


def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _ladder(k: int, u: int) -> int:
    x1, x2, z2, x3, z3, swap = u, 1, 0, u, 1, 0
    for t in range(254, -1, -1):
        bit = (k >> t) & 1
        if swap ^ bit:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % P, b * b % P
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % P, c * b % P
        x3 = (da + cb) ** 2 % P
        z3 = x1 * ((da - cb) ** 2 % P) % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, P - 2, P) % P


def x25519(private: bytes, public: bytes) -> bytes:
    """The shared secret of `private` and the peer's `public` (32 bytes
    each); ValueError when it is all zeros (a low-order point)."""
    if len(private) != 32 or len(public) != 32:
        raise ValueError("X25519 keys are 32 bytes")
    u = int.from_bytes(public, "little") & ((1 << 255) - 1)
    out = _ladder(_clamp(private), u % P).to_bytes(32, "little")
    if out == bytes(32):
        raise ValueError("X25519 shared secret is all zeros")
    return out


def x25519_public(private: bytes) -> bytes:
    if len(private) != 32:
        raise ValueError("X25519 keys are 32 bytes")
    return _ladder(_clamp(private), 9).to_bytes(32, "little")


# ---------------------------------------------------------------------------
# Ed25519 on extended coordinates (X, Y, Z, T), x = X/Z, y = Y/Z, xy = T/Z

_IDENTITY = (0, 1, 1, 0)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _double(p):
    x1, y1, z1, _ = p
    a, b = x1 * x1 % P, y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) ** 2 % P
    g = a - b
    f = c + g
    return e * f % P, g * h % P, f * g % P, e * h % P


def _neg(p):
    x, y, z, t = p
    return (-x) % P, y, z, (-t) % P


def _mul(k: int, p):
    """[k]p by 4-bit windows, most significant first."""
    table = [_IDENTITY, p]
    for _ in range(14):
        table.append(_add(table[-1], p))
    q = _IDENTITY
    for shift in range(252, -1, -4):
        q = _double(_double(_double(_double(q))))
        w = (k >> shift) & 15
        if w:
            q = _add(q, table[w])
    return q


_BASE_TABLE: list | None = None


def _base_table():
    """[j·16^i]B for i < 64, j < 16: a fixed-base product is 64 additions."""
    global _BASE_TABLE
    if _BASE_TABLE is None:
        y = 4 * pow(5, P - 2, P) % P
        x = _recover_x(y, 0)
        g = (x, y, 1, x * y % P)
        rows = []
        for _ in range(64):
            row = [_IDENTITY, g]
            for _ in range(14):
                row.append(_add(row[-1], g))
            rows.append(row)
            g = _double(_double(_double(_double(g))))
        _BASE_TABLE = rows
    return _BASE_TABLE


def _mul_base(k: int):
    rows = _base_table()
    q = _IDENTITY
    for i in range(64):
        w = (k >> (4 * i)) & 15
        if w:
            q = _add(q, rows[i][w])
    return q


def _recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vx2 = v * x * x % P
    if vx2 == (-u) % P:
        x = x * SQRT_M1 % P
    elif vx2 != u:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x


def _encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decode(data: bytes):
    if len(data) != 32:
        return None
    v = int.from_bytes(data, "little")
    y, sign = v & ((1 << 255) - 1), v >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return x, y, 1, x * y % P


def _expand(private: bytes) -> tuple[int, bytes, bytes]:
    """(the secret scalar a, the nonce prefix, the public key A)."""
    if len(private) != 32:
        raise ValueError("Ed25519 private keys are 32 bytes")
    h = hashlib.sha512(private).digest()
    a = _clamp(h[:32])
    return a, h[32:], _encode(_mul_base(a))


def _h512(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little") % L


def ed25519_public(private: bytes) -> bytes:
    return _expand(private)[2]


def ed25519_sign(private: bytes, message: bytes, expanded=None) -> bytes:
    """RFC 8032 §5.1.6; `expanded` is `_expand(private)`, kept by a caller
    that signs often."""
    a, prefix, pub = expanded or _expand(private)
    r = _h512(prefix, message)
    rb = _encode(_mul_base(r))
    s = (r + _h512(rb, pub, message) * a) % L
    return rb + s.to_bytes(32, "little")


def ed25519_verify(public: bytes, signature: bytes, message: bytes) -> bool:
    if len(signature) != 64:
        return False
    a = _decode(public)
    if a is None:
        return False
    rb, s = signature[:32], int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = _h512(rb, public, message)
    return _encode(_add(_mul_base(s), _neg(_mul(k, a)))) == rb


# ---------------------------------------------------------------------------
# HKDF-SHA256 and the AEAD


def hkdf_sha256(secret: bytes, salt: bytes, info: bytes, length: int = 32) -> bytes:
    if length > 255 * 32:
        raise ValueError("HKDF-SHA256 output is at most 8160 bytes")
    prk = hmac.new(salt or bytes(32), secret, hashlib.sha256).digest()
    out, block = b"", b""
    for i in range(1, -(-length // 32) + 1):
        block = hmac.new(prk, block + info + bytes([i]), hashlib.sha256).digest()
        out += block
    return out[:length]


class ChaCha20Poly1305:
    """RFC 8439 AEAD with one key; `encrypt` returns ciphertext || tag,
    `decrypt` raises `InvalidTag` when the tag does not verify."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20-Poly1305 keys are 32 bytes")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None = b"") -> bytes:
        return native.aead_seal(self._key, nonce, data, aad or b"")

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None = b"") -> bytes:
        out = native.aead_open(self._key, nonce, data, aad or b"")
        if out is None:
            raise InvalidTag("ChaCha20-Poly1305 tag mismatch")
        return out
