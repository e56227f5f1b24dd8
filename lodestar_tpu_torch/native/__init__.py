"""The C host tier of BLS12-381 through its plain C ABI (`ctypes`).

The sources are the port's own copy under `csrc/host/` (bls12.c,
bls12_consts.h, sha256.c, for the network snappy_codec.c,
xxhash64.c and chacha20poly1305.c, for the validator's keystores
aes128ctr.c, and for the database kvstore.c), built by `build.host_tier()` with
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
            "lodestar_bls_aggregate_verify": [_SZ, _VP, _VP, _VP, _VP, _VP, _SZ],
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
        lib.lodestar_aes128ctr.argtypes = [_VP, _VP, _VP, _SZ, _VP]
        lib.lodestar_aes128ctr.restype = None
        _U64 = ctypes.c_uint64
        for name, argtypes, restype in (
                ("lodestar_kv_open_with", [ctypes.c_char_p, _U64, _INT], _VP),
                ("lodestar_kv_put", [_VP, _VP, _SZ, _VP, _SZ, _INT], _INT),
                ("lodestar_kv_delete", [_VP, _VP, _SZ, _INT], _INT),
                ("lodestar_kv_sync", [_VP], _INT),
                ("lodestar_kv_get", [_VP, _VP, _SZ, _VP, _SZ], ctypes.c_int64),
                ("lodestar_kv_range", [_VP, _VP, _SZ, _VP, _SZ, ctypes.POINTER(_U64)],
                 ctypes.POINTER(_KeyRef)),
                ("lodestar_kv_free", [_VP], None),
                ("lodestar_kv_count", [_VP], _U64),
                ("lodestar_kv_stats", [_VP, ctypes.POINTER(_U64 * 4)], None),
                ("lodestar_kv_compact", [_VP], _INT),
                ("lodestar_kv_should_compact", [_VP], _INT),
                ("lodestar_kv_close", [_VP], None)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _FN = lib
    return _FN


class _KeyRef(ctypes.Structure):
    """`kv_keyref` of kvstore.c: a key in the engine's arena."""

    _fields_ = [("key", ctypes.c_void_p), ("len", ctypes.c_uint16)]


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


def aes128ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128 in counter mode (EIP-2335's cipher): `data` XOR the key
    stream from the 16-byte counter block `iv`, stepped as a 128-bit
    big-endian integer. Encrypts and decrypts alike."""
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("AES-128-CTR takes a 16-byte key and a 16-byte counter block")
    out = ctypes.create_string_buffer(max(len(data), 1))
    _lib().lodestar_aes128ctr(bytes(key), bytes(iv), bytes(data), len(data), out)
    return out.raw[:len(data)]


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


def aggregate_verify(pks: bytes, msgs: list[bytes], sig: bytes, dst: bytes) -> bool:
    """AggregateVerify of n keys (n×48 B) on their n messages under one
    96 B signature: Π e(pkᵢ, H(mᵢ)) · e(−g1, sig) == 1 (keys and the
    signature subgroup-checked; an infinity key or signature is False)."""
    n = len(msgs)
    if len(pks) != 48 * n or len(sig) != 96:
        raise ValueError("need n*48 pubkey and 96 signature bytes")
    lens = np.asarray([len(m) for m in msgs], np.uint64)
    return _lib().lodestar_bls_aggregate_verify(
        n, _buf(pks), _buf(b"".join(msgs) or b"\0"), _ptr(lens), _buf(sig),
        _buf(dst), len(dst)) == 1


# -- the KV engine (csrc/host/kvstore.c) -------------------------------------
# The JAX package binds these through CPython wrappers (`module.c:380-480`);
# here each is one ctypes call, which releases the GIL as those do. The
# handle is the engine's pointer; the caller serializes calls on it.


def kv_open(path: str, seg_limit: int = 0, verify_reads: bool = False) -> int:
    """Open (and replay) the KV datadir `path` → handle. `seg_limit`: the
    segment rotation size in bytes (0: 256 MiB); `verify_reads`: check
    each record's CRC on get. OSError when it cannot be opened."""
    h = _lib().lodestar_kv_open_with(str(path).encode(), int(seg_limit), int(verify_reads))
    if not h:
        raise OSError(f"kv_open failed for {path}")
    return h


def kv_put(h: int, key: bytes, value: bytes, sync: bool = True) -> None:
    key, value = bytes(key), bytes(value)
    if _lib().lodestar_kv_put(h, key, len(key), value, len(value), int(sync)) != 0:
        raise OSError("kv_put failed")


def kv_batch_put(h: int, items) -> None:
    """Every (key, value) written, then one fsync."""
    for k, v in items:
        kv_put(h, k, v, sync=False)
    kv_sync(h)


def kv_delete(h: int, key: bytes, sync: bool = True) -> None:
    key = bytes(key)
    if _lib().lodestar_kv_delete(h, key, len(key), int(sync)) != 0:
        raise OSError("kv_delete failed")


def kv_sync(h: int) -> None:
    if _lib().lodestar_kv_sync(h) != 0:
        raise OSError("kv_sync failed")


def kv_get(h: int, key: bytes) -> bytes | None:
    key = bytes(key)
    lib = _lib()
    small = ctypes.create_string_buffer(4096)
    n = lib.lodestar_kv_get(h, key, len(key), small, 4096)
    if n == -1:
        return None
    if n < 0:
        raise OSError("kv_get IO error")
    if n <= 4096:
        return small.raw[:n]
    out = ctypes.create_string_buffer(n)
    if lib.lodestar_kv_get(h, key, len(key), out, n) != n:
        raise OSError("kv_get IO error")
    return out.raw


def kv_range(h: int, gte: bytes, lt: bytes) -> list[bytes]:
    """The keys in [gte, lt), sorted (an empty bound is open)."""
    gte, lt = bytes(gte), bytes(lt)
    lib = _lib()
    n = ctypes.c_uint64(0)
    arr = lib.lodestar_kv_range(h, gte, len(gte), lt, len(lt), ctypes.byref(n))
    if not arr:
        raise MemoryError("kv_range failed")
    try:
        return [ctypes.string_at(arr[i].key, arr[i].len) for i in range(n.value)]
    finally:
        lib.lodestar_kv_free(ctypes.cast(arr, ctypes.c_void_p))


def kv_count(h: int) -> int:
    return int(_lib().lodestar_kv_count(h))


def kv_stats(h: int) -> tuple[int, int, int, int]:
    """(count, live_bytes, dead_bytes, active_segment)."""
    out = (ctypes.c_uint64 * 4)()
    _lib().lodestar_kv_stats(h, ctypes.byref(out))
    return tuple(int(v) for v in out)


def kv_should_compact(h: int) -> bool:
    return bool(_lib().lodestar_kv_should_compact(h))


def kv_compact(h: int, force: bool = False) -> bool:
    """Compact when the dead bytes pass the gate (or `force`); True when it
    ran."""
    if not force and not kv_should_compact(h):
        return False
    if _lib().lodestar_kv_compact(h) != 0:
        raise OSError("kv_compact failed")
    return True


def kv_close(h: int) -> None:
    """fsync and close; the handle is dead after."""
    _lib().lodestar_kv_close(h)
