"""The C host tier of BLS12-381 through its plain C ABI (`ctypes`).

The sources are the port's own copy under `csrc/host/` (bls12.c,
bls12_consts.h, sha256.c), built by `build.host_tier()` with `cc` at
first use. Limb outputs are (..., 32) int32 Montgomery limbs, the layout
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
