"""Limb representation of Fp (the BLS12-381 base field) in int32 tensors.

A field element is a little-endian vector of 32 limbs × 12 bits held in
int32, the JAX package's layout, so both packages exchange the same
arrays. Schoolbook products of 12-bit limbs are < 2^24 and a full
32-term convolution column stays < 2^29: every intermediate of the
Montgomery pipeline fits signed int32.

Values are kept in Montgomery form (a·R mod p, R = 2^384) and range over
[0, 2p) between operations (lazy reduction); `fp.canonical` gives the
unique representative < p. The trailing axis (size 32) is the limb axis.
"""

from __future__ import annotations

import numpy as np

from ..bls.fields import P

LIMB_BITS = 12
N_LIMBS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
DTYPE = np.int32

# Montgomery radix
R_MONT = 1 << (LIMB_BITS * N_LIMBS)  # 2^384
R2 = (R_MONT * R_MONT) % P  # for to_mont: a·R = REDC(a · R2)
# −p⁻¹ mod 2^12 (p is odd)
N0 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def int_to_limbs(x: int) -> np.ndarray:
    """Python int → (32,) int32 little-endian 12-bit limbs; x < 2^384."""
    if not 0 <= x < R_MONT:
        raise ValueError("value out of 384-bit range")
    out = np.zeros(N_LIMBS, dtype=DTYPE)
    for i in range(N_LIMBS):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    """(32,) limbs → Python int (one element only)."""
    arr = np.asarray(limbs)
    if arr.ndim != 1:
        raise ValueError("limbs_to_int takes a single element")
    acc = 0
    for i in reversed(range(N_LIMBS)):
        acc = (acc << LIMB_BITS) | int(arr[i])
    return acc


P_LIMBS = int_to_limbs(P)
TWO_P_LIMBS = int_to_limbs(2 * P)
R2_LIMBS = int_to_limbs(R2)
ONE_MONT_LIMBS = int_to_limbs(R_MONT % P)  # 1 in Montgomery form
ZERO_LIMBS = np.zeros(N_LIMBS, dtype=DTYPE)


def fp_to_mont_host(x: int) -> np.ndarray:
    """Normal-domain int → Montgomery-form limbs."""
    return int_to_limbs((x * R_MONT) % P)


def fp_from_mont_host(limbs) -> int:
    """Montgomery-form limbs → normal-domain int."""
    return (limbs_to_int(limbs) * pow(R_MONT, -1, P)) % P
