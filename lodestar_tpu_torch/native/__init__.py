"""The C host tier of BLS12-381 through its plain C ABI (`ctypes`).

The sources are the port's own copy under `csrc/host/` (bls12.c,
bls12_consts.h, sha256.c, and for the network snappy_codec.c,
xxhash64.c and chacha20poly1305.c), built by `build.host_tier()` with
`cc` at first use (there is no Python fallback: without a C compiler
these calls raise). Limb outputs are (..., 32) int32 Montgomery limbs, the layout
of `ops/limbs.py`. ctypes releases the GIL for each call, so the batch
helpers split their work across threads.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..build import host_tier

_VP = ctypes.c_void_p
_SZ = ctypes.c_size_t
_INT = ctypes.c_int
_FN = None


def _lib():
    global _FN
    if _FN is None:
        lib = host_tier()
        sigs = {
            "lodestar_bls_g1_decompress": [_VP, _VP, _VP, _INT],
            "lodestar_bls_g2_decompress": [_VP, _VP, _VP, _INT],
            "lodestar_bls_g1_aggregate": [_VP, _SZ, _INT, _VP],
            "lodestar_bls_g2_aggregate": [_VP, _SZ, _INT, _VP],
            "lodestar_bls_hash_to_g2": [_VP, _SZ, _VP, _SZ, _VP, _VP],
            "lodestar_bls_sign": [_VP, _VP, _SZ, _VP, _SZ, _VP],
            "lodestar_bls_sk_to_pk": [_VP, _VP],
            "lodestar_bls_verify_sets": [_SZ, _VP, _VP, _VP, _VP, _VP, _SZ, _VP, _VP, _VP],
            "lodestar_bls_marshal_sets": [_SZ, _VP, _VP, _VP, _VP, _SZ, _INT, _INT, _INT,
                                          _INT] + [_VP] * 7,
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        lib.lodestar_sha256_level.argtypes = [_VP, _SZ, _VP]
        lib.lodestar_sha256_level.restype = None
        lib.lodestar_xxh64.argtypes = [_VP, _SZ, ctypes.c_uint64]
        lib.lodestar_xxh64.restype = ctypes.c_uint64
        lib.lodestar_snappy_max_compressed.argtypes = [_SZ]
        lib.lodestar_snappy_max_compressed.restype = _SZ
        lib.lodestar_snappy_compress.argtypes = [_VP, _SZ, _VP]
        lib.lodestar_snappy_compress.restype = _SZ
        lib.lodestar_snappy_uncompress.argtypes = [_VP, _SZ, _VP, _SZ]
        lib.lodestar_snappy_uncompress.restype = _INT
        for name in ("lodestar_aead_seal", "lodestar_aead_open"):
            fn = getattr(lib, name)
            fn.argtypes = [_VP, _VP, _VP, _SZ, _VP, _SZ, _VP]
            fn.restype = _INT
        _FN = lib
    return _FN


def _buf(data: bytes):
    return ctypes.create_string_buffer(bytes(data), len(data))


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def g1_decompress(data: bytes, check_subgroup: bool = True):
    """48 B compressed G1 → (rc, (2, 32) int32 x/y limbs).
    rc: 0 ok, 1 infinity, −1 malformed, −2 off-curve, −3 subgroup."""
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    out = np.zeros((2, 32), np.int32)
    rc = _lib().lodestar_bls_g1_decompress(
        _buf(data), _ptr(out[0]), _ptr(out[1]), int(check_subgroup))
    return rc, out


def g2_decompress(data: bytes, check_subgroup: bool = True):
    """96 B compressed G2 → (rc, (2, 2, 32) int32 x/y limbs), rc as for
    `g1_decompress`."""
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    out = np.zeros((2, 2, 32), np.int32)
    rc = _lib().lodestar_bls_g2_decompress(
        _buf(data), _ptr(out[0]), _ptr(out[1]), int(check_subgroup))
    return rc, out


def g1_aggregate(pks: bytes, check_each: bool = False):
    """n × 48 B compressed G1 keys → (rc, 48 B compressed sum). rc: 0 ok,
    1 the sum is infinity (its encoding returned), −1 malformed, −2
    off-curve, −3 a key out of the subgroup (only with `check_each`).
    Infinity keys add nothing."""
    if len(pks) % 48:
        raise ValueError("need n*48 pubkey bytes")
    out = ctypes.create_string_buffer(48)
    rc = _lib().lodestar_bls_g1_aggregate(_buf(pks), len(pks) // 48, int(check_each), out)
    return rc, out.raw


def g2_aggregate(sigs: bytes, check_each: bool = False):
    """n × 96 B compressed G2 signatures → (rc, 96 B compressed sum), rc
    as for `g1_aggregate`."""
    if len(sigs) % 96:
        raise ValueError("need n*96 signature bytes")
    out = ctypes.create_string_buffer(96)
    rc = _lib().lodestar_bls_g2_aggregate(_buf(sigs), len(sigs) // 96, int(check_each), out)
    return rc, out.raw


def sha256_level(data: bytes) -> bytes:
    """N × 64 bytes → N × 32 bytes: one merkle level in one C call."""
    n = len(data) // 64
    if len(data) != 64 * n:
        raise ValueError("a level is n*64 bytes")
    out = ctypes.create_string_buffer(32 * n)
    if n:
        _lib().lodestar_sha256_level(data, n, out)
    return out.raw


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the gossip fast message id)."""
    return int(_lib().lodestar_xxh64(bytes(data), len(data), seed))


def snappy_compress(data: bytes) -> bytes:
    """Snappy block format: the varint length, then literals and copies."""
    data = bytes(data)
    if len(data) > 0xFFFFFFFF:
        raise ValueError("input too large for snappy block")
    lib = _lib()
    out = ctypes.create_string_buffer(lib.lodestar_snappy_max_compressed(len(data)))
    n = lib.lodestar_snappy_compress(data, len(data), out)
    if n == 0:
        raise MemoryError("snappy compression failed")
    return out.raw[:n]


def _snappy_declared(data: bytes) -> int:
    value = 0
    for i in range(min(len(data), 5)):
        value |= (data[i] & 0x7F) << (7 * i)
        if not data[i] & 0x80:
            if value > 0xFFFFFFFF:
                break
            return value
    raise ValueError("bad snappy header")


def snappy_uncompress(data: bytes) -> bytes:
    """The inverse of `snappy_compress`; ValueError on a corrupt stream."""
    data = bytes(data)
    declared = _snappy_declared(data)
    out = ctypes.create_string_buffer(max(declared, 1))
    rc = _lib().lodestar_snappy_uncompress(data, len(data), out, declared)
    if rc != 0:
        raise ValueError(f"corrupt snappy stream ({rc})")
    return out.raw[:declared]


def aead_seal(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """ChaCha20-Poly1305 (RFC 8439): ciphertext || 16-byte tag."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20-Poly1305 takes a 32-byte key and a 12-byte nonce")
    out = ctypes.create_string_buffer(len(plaintext) + 16)
    _lib().lodestar_aead_seal(bytes(key), bytes(nonce), bytes(aad), len(aad),
                              bytes(plaintext), len(plaintext), out)
    return out.raw


def aead_open(key: bytes, nonce: bytes, ciphertext: bytes, aad: bytes = b"") -> bytes | None:
    """The plaintext of `aead_seal`'s output, or None when its tag does
    not verify."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20-Poly1305 takes a 32-byte key and a 12-byte nonce")
    if len(ciphertext) < 16:
        return None
    out = ctypes.create_string_buffer(max(len(ciphertext) - 16, 1))
    rc = _lib().lodestar_aead_open(bytes(key), bytes(nonce), bytes(aad), len(aad),
                                   bytes(ciphertext), len(ciphertext), out)
    return None if rc else out.raw[:len(ciphertext) - 16]


def install_ssz_backend() -> None:
    """Route SSZ merkleization (`ssz.hashing`, `ssz.tree_cache`) through
    `sha256_level`; the default is hashlib."""
    from ..ssz import hashing

    hashing.set_hash_backend(sha256_level)


def hash_to_g2(msg: bytes, dst: bytes):
    """RFC 9380 hash_to_curve → (rc, (2, 2, 32) int32 x/y limbs)."""
    out = np.zeros((2, 2, 32), np.int32)
    rc = _lib().lodestar_bls_hash_to_g2(
        _buf(msg), len(msg), _buf(dst), len(dst), _ptr(out[0]), _ptr(out[1]))
    return rc, out


def sign(sk_be: bytes, msg: bytes, dst: bytes):
    """[sk]·H(msg) → (rc, 96 B compressed G2 signature)."""
    if len(sk_be) != 32:
        raise ValueError("secret key must be 32 bytes")
    out = ctypes.create_string_buffer(96)
    rc = _lib().lodestar_bls_sign(
        _buf(sk_be), _buf(msg), len(msg), _buf(dst), len(dst), out)
    return rc, out.raw


def sk_to_pk(sk_be: bytes):
    """[sk]·g1 → (rc, 48 B compressed G1 public key)."""
    if len(sk_be) != 32:
        raise ValueError("secret key must be 32 bytes")
    out = ctypes.create_string_buffer(48)
    rc = _lib().lodestar_bls_sk_to_pk(_buf(sk_be), out)
    return rc, out.raw


def bls_marshal_sets(pks: bytes, msgs: bytes, sigs: bytes, dst: bytes,
                     check_pk_subgroup: bool = False,
                     check_sig_subgroup: bool = True,
                     do_hash: bool = True, do_pk: bool = True):
    """Marshal n signature sets into limb arrays in one C call.

    pks n×48 B, msgs n×32 B signing roots, sigs n×96 B →
    (pk_x (n, 32), pk_y (n, 32), msg_x (n, 2, 32), msg_y, sig_x, sig_y,
    ok (n,) bool). A set whose decompression or subgroup check fails, or
    whose pubkey or signature is infinity, gets ok False. Pubkey subgroup
    checks default off (keys were validated when they were made),
    signature subgroup checks on. do_hash=False skips hash-to-curve and
    do_pk=False pubkey decompression (the caller fills those arrays from
    its caches); the skipped arrays stay zero."""
    n = len(pks) // 48
    if len(pks) % 48 or len(msgs) != 32 * n or len(sigs) != 96 * n:
        raise ValueError("need n*48 pubkey, n*32 message, n*96 signature bytes")
    pk = np.zeros((2, n, 32), np.int32)
    msg = np.zeros((2, n, 2, 32), np.int32)
    sig = np.zeros((2, n, 2, 32), np.int32)
    ok = np.zeros(n, np.uint8)
    if n:
        _lib().lodestar_bls_marshal_sets(
            n, _buf(pks), _buf(msgs), _buf(sigs), _buf(dst), len(dst),
            int(check_pk_subgroup), int(check_sig_subgroup), int(do_hash), int(do_pk),
            _ptr(pk[0]), _ptr(pk[1]), _ptr(msg[0]), _ptr(msg[1]), _ptr(sig[0]),
            _ptr(sig[1]), _ptr(ok))
    return pk[0], pk[1], msg[0], msg[1], sig[0], sig[1], ok.astype(bool)


def _verify_chunk(pks: bytes, msgs: list[bytes], sigs: bytes, dst: bytes) -> list[bool]:
    n = len(msgs)
    ok = np.zeros(n, np.uint8)
    lens = np.asarray([len(m) for m in msgs], np.uint64)
    _lib().lodestar_bls_verify_sets(
        n, _buf(pks), _buf(b"".join(msgs) or b"\0"), _ptr(lens), _buf(sigs),
        _buf(dst), len(dst), None, None, _ptr(ok))
    return [bool(b) for b in ok]


def verify_sets(pks: bytes, msgs: list[bytes], sigs: bytes, dst: bytes,
                threads: int = 1) -> list[bool]:
    """Full CPU verification of n signature sets (decompression, subgroup
    checks, hash-to-curve, two pairings per set) → per-set verdicts.
    `threads` > 1 splits the sets across threads."""
    n = len(msgs)
    if len(pks) != 48 * n or len(sigs) != 96 * n:
        raise ValueError("need n*48 pubkey and n*96 signature bytes")
    if threads <= 1 or n < 2 * threads:
        return _verify_chunk(pks, msgs, sigs, dst)
    bounds = np.linspace(0, n, threads + 1).astype(int)
    with ThreadPoolExecutor(threads) as pool:
        parts = pool.map(lambda lo_hi: _verify_chunk(
            pks[48 * lo_hi[0]: 48 * lo_hi[1]], msgs[lo_hi[0]: lo_hi[1]],
            sigs[96 * lo_hi[0]: 96 * lo_hi[1]], dst,
        ), zip(bounds[:-1], bounds[1:]))
        return [v for part in parts for v in part]
