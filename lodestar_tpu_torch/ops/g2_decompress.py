"""G2 signature decompression and the batched plane subgroup check.

The port of the JAX package's `ops/g2_decompress.py`, limb for limb.

- `decompress`: ZCash-format 96-byte compressed G2 points are unpacked to
  12-bit limbs by static byte gathers, validated (flags, coordinate
  range, curve membership), and y is recovered by a branchless Fp2
  square root (`fp2_sqrt`, the complex method: two Fp power chains per
  lane, the inverse free from the same chain); the sign comes from the
  compression flag.
- `planes_in_subgroup`: instead of a per-lane check, the verifier's
  random bit-plane sums U_b are checked: ψ(U_b) == [x]·U_b on all 64
  planes, which lets an out-of-subgroup signature through with
  probability ≤ 2^-64 over the same randomness as the batch equation.

Fp2 sqrt (p ≡ 3 mod 4) for c = c0 + c1·u:
    n = c0² + c1², λ = n^((p+1)/4) (λ² == n else reject),
    t = (c0 + λ)/2, u* = t^((p−3)/4), e₀ = u*·t, χ = u*·e₀ (= ±1);
    χ = 1:  y = e₀ + (c1/2)·u*·u;   χ = −1: y = −(c1/2)·u* + e₀·u.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls.fields import P as _P_INT
from ..bls.fields import Fq
from . import fp, fp2
from .io_host import fq_to_limbs
from .limbs import N_LIMBS, P_LIMBS, int_to_limbs
from .pairing import X_ABS
from .points import g2, g2_psi

INV2 = fq_to_limbs(Fq(pow(2, -1, _P_INT)))  # Montgomery 1/2
# canonical c > (p−1)/2  ⟺  c >= (p+1)/2
HALF_P1 = int_to_limbs((_P_INT + 1) // 2)
B2 = np.stack([fq_to_limbs(Fq(4)), fq_to_limbs(Fq(4))])  # 4(1+u)

_POW_SQRT = (_P_INT + 1) // 4
_POW_U = (_P_INT - 3) // 4

# byte→limb static gather: little-endian byte j holds bits 8j..8j+7 of the
# 384-bit coordinate; limb i holds bits 12i..12i+11
_IDX0 = np.array([(12 * i) // 8 for i in range(N_LIMBS)], np.int64)
_SHIFT = np.array([(12 * i) % 8 for i in range(N_LIMBS)], np.int32)
_IDX1 = np.minimum(_IDX0 + 1, 47)
_HAS_HI = (_IDX0 + 1 < 48).astype(np.int32)


def _bytes48_to_limbs(be_bytes):
    """(..., 48) big-endian bytes (int32) → (..., 32) int32 canonical
    12-bit limbs (normal domain, NOT Montgomery)."""
    dev = be_bytes.device
    le = torch.flip(be_bytes.to(torch.int32), (-1,))
    lo = torch.index_select(le, -1, fp.const(_IDX0, dev))
    hi = torch.index_select(le, -1, fp.const(_IDX1, dev)) * fp.const(_HAS_HI, dev)
    sh = fp.const(_SHIFT, dev)
    return ((lo >> sh) + (hi << (8 - sh))) & 0xFFF


def _lex_lt_p(a):
    """a < p on canonical limb vectors."""
    return ~fp._lex_ge(a, fp.const(P_LIMBS, a.device))


def fp2_sqrt(c):
    """Branchless Fp2 square root: c (..., 2, 32) Montgomery limbs →
    (y, ok) with y² == c where ok; ok False where c has no root (or hits
    the c1 = 0, non-QR c0 corner; callers treat either as invalid)."""
    dev = c.device
    inv2 = fp.const(INV2, dev)
    c0 = c[..., 0, :]
    c1 = c[..., 1, :]
    pair = torch.stack([c0, c1], 0)
    sq = fp.mul(pair, pair)
    n = fp.add(sq[0], sq[1])
    lam = fp.pow_const(n, _POW_SQRT)
    lam_ok = fp.eq(fp.mul(lam, lam), n)
    t = fp.mul(fp.add(c0, lam), inv2)
    u_ = fp.pow_const(t, _POW_U)
    pr = fp.mul(torch.stack([u_, c1], 0), torch.stack([t, inv2.expand(t.shape)], 0))
    e0, c1h = pr[0], pr[1]  # e₀ = u*·t, c1h = c1/2
    chi_one = fp.eq(fp.mul(u_, e0), fp.one_mont(tuple(e0.shape[:-1]), dev))
    f0 = fp.mul(c1h, u_)
    e = fp.select(chi_one, e0, fp.neg(f0))
    f = fp.select(chi_one, f0, e0)
    y = torch.stack([e, f], dim=-2)
    ok = lam_ok & fp2.eq(fp2.square(y), c)
    return y, ok


def _y_is_lex_larger(y):
    """ZCash sort flag: y > −y comparing (c1, then c0) canonically."""
    yc = torch.stack([fp.from_mont(y[..., 0, :]), fp.from_mont(y[..., 1, :])], -2)
    half = fp.const(HALF_P1, y.device)
    c0_big = fp._lex_ge(yc[..., 0, :], half)
    c1_big = fp._lex_ge(yc[..., 1, :], half)
    c1_zero = torch.all(yc[..., 1, :] == 0, dim=-1)
    return torch.where(c1_zero, c0_big, c1_big)


def decompress(raw):
    """Decompress ZCash-format G2 signatures: raw (..., 96) uint8 →
    (x, y, ok), x and y (..., 2, 32) Montgomery limbs of an affine curve
    point; ok False for malformed flags, out-of-range coordinates, an
    off-curve x, the infinity encoding or the sqrt corner. Coordinates of
    !ok lanes are garbage (callers mask). Subgroup membership is checked
    by the verifier on its random plane sums (`planes_in_subgroup`)."""
    raw = raw.to(torch.int32)
    flags = raw[..., 0]
    compressed = (flags & 0x80) != 0
    infinity = (flags & 0x40) != 0
    sign = (flags & 0x20) != 0

    top = raw.clone()
    top[..., 0] = flags & 0x1F
    xc1 = _bytes48_to_limbs(top[..., :48])
    xc0 = _bytes48_to_limbs(top[..., 48:96])
    in_range = _lex_lt_p(xc1) & _lex_lt_p(xc0)
    x = torch.stack([fp.to_mont(xc0), fp.to_mont(xc1)], dim=-2)

    # y² = x³ + 4(1+u)
    xsq = fp2.square(x)
    rhs = fp2.add(fp2.mul(xsq, x), fp.const(B2, x.device))
    y, sqrt_ok = fp2_sqrt(rhs)
    flip = _y_is_lex_larger(y) != sign
    y = fp2.select(~flip, y, fp2.neg(y))

    ok = compressed & ~infinity & in_range & sqrt_ok
    return x, y, ok


def g2_mul_x_abs(p):
    """[|x|]·P by a static double-and-add (63 doublings, 5 additions)."""
    bits = bin(X_ABS)[2:]
    acc = p
    for b in bits[1:]:
        acc = g2.double(acc)
        if b == "1":
            acc = g2.add(acc, p)
    return acc


def planes_in_subgroup(u_planes):
    """ψ(U_b) == [x]·U_b over the leading plane axis → scalar bool tensor.
    x < 0, so the right side is −[|x|]·U_b; infinity planes pass."""
    lhs = g2_psi(u_planes)
    rhs = g2.neg(g2_mul_x_abs(u_planes))
    return torch.all(g2.eq(lhs, rhs))
