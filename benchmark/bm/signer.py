"""The inputs' signer: a frozen copy of the host tier's C BLS12-381 code
(`frozen/bls12.c` with `bls12_consts.h` and `sha256.c`), built with `cc`
into `build/benchmark/` inside the checkout and bound through two entries,
`lodestar_bls_sk_to_pk` and `lodestar_bls_sign`.

The copy does not follow later changes to the program's host tier, so the
keys and signatures that a seed gives stay the same for every commit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

from .paths import BUILD_DIR, HERE

FROZEN = os.path.join(HERE, "frozen")
SOURCES = ("bls12.c", "sha256.c")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c11")
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

_lib = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + ("bls12_consts.h",):
        with open(os.path.join(FROZEN, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """The built library, built first when it is not there."""
    path = os.path.join(BUILD_DIR, f"libbench_signer-{_digest()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["cc", *FLAGS, "-o", tmp, *(os.path.join(FROZEN, s) for s in SOURCES)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, path)
    return path


def lib():
    global _lib
    if _lib is None:
        so = ctypes.CDLL(library_path())
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        so.lodestar_bls_sign.argtypes = [vp, vp, sz, vp, sz, vp]
        so.lodestar_bls_sign.restype = ctypes.c_int
        so.lodestar_bls_sk_to_pk.argtypes = [vp, vp]
        so.lodestar_bls_sk_to_pk.restype = ctypes.c_int
        _lib = so
    return _lib


def sk_to_pk(sk: int) -> bytes:
    out = ctypes.create_string_buffer(48)
    skb = sk.to_bytes(32, "big")
    if lib().lodestar_bls_sk_to_pk(skb, out) != 0:
        raise ValueError("secret key out of range")
    return out.raw


def sign(sk: int, msg: bytes) -> bytes:
    out = ctypes.create_string_buffer(96)
    skb = sk.to_bytes(32, "big")
    if lib().lodestar_bls_sign(skb, msg, len(msg), DST, len(DST), out) != 0:
        raise ValueError("signing failed")
    return out.raw


def pubkeys(sks, threads: int = 8) -> list[bytes]:
    """Public keys of many secret keys; the C calls release the GIL."""
    lib()
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(sk_to_pk, sks))


def signatures(jobs, threads: int = 8) -> list[bytes]:
    """Signatures of many (sk, msg) pairs."""
    lib()
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(lambda j: sign(*j), jobs))
