"""Fp12 = Fp6[w]/(w² − v) on int32 limb tensors.

Element shape (..., 2, 3, 2, 32): axis −4 indexes (c0, c1) of c0 + c1·w.
A full multiplication is 3 Fp6 products stacked into ONE fp6.mul call;
the pairing's line update uses the sparse `mul_by_line`. Frobenius maps
use the flattened Fq2[w]/(w⁶ − ξ) view with γ constants built on the host
from the port's own oracle (`bls.fields.FROB_GAMMA`). Limb for limb the
JAX package's `ops/fp12.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls import fields as _f
from . import fp, fp2, fp6
from .limbs import N_LIMBS, fp_to_mont_host


def _split(a):
    return a[..., 0, :, :, :], a[..., 1, :, :, :]


def _join(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def _bcast(a, b):
    batch = fp.broadcast_shapes(a.shape[:-4], b.shape[:-4])
    return (
        torch.broadcast_to(a, batch + a.shape[-4:]),
        torch.broadcast_to(b, batch + b.shape[-4:]),
    )


def add(a, b):
    return fp.add(a, b)


def mul(a, b):
    """Karatsuba over w: c0 = v0 + v·v1, c1 = (a0+a1)(b0+b1) − v0 − v1,
    with the operand sums and the interpolation as single combines."""
    a, b = _bcast(a, b)
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    sa, sb = fp.reduce_sums(torch.stack([a0 + a1, b0 + b1]))
    v = fp6.mul(torch.stack([a0, a1, sa], dim=0), torch.stack([b0, b1, sb], dim=0))
    v0, v1, v01 = v[0], v[1], v[2]
    W = fp.wrap
    c0 = W(v0) + fp6.mul_by_v_s(W(v1))
    c1 = W(v01) - W(v0) - W(v1)
    c0, c1 = fp.reduce_stack([c0, c1])
    return _join(c0, c1)


def square(a):
    """Complex squaring: c0 = (a0+a1)(a0+v·a1) − v0 − v·v0, c1 = 2v0."""
    a0, a1 = _split(a)
    W = fp.wrap
    s0, s1 = fp.reduce_stack([W(a0) + W(a1), W(a0) + fp6.mul_by_v_s(W(a1))])
    v = fp6.mul(torch.stack([a0, s0], dim=0), torch.stack([a1, s1], dim=0))
    v0, mixed = v[0], v[1]
    c0 = W(mixed) - W(v0) - fp6.mul_by_v_s(W(v0))
    c1 = W(v0).double()
    c0, c1 = fp.reduce_stack([c0, c1])
    return _join(c0, c1)


def conj(a):
    """x^(p⁶): negate the w component."""
    a0, a1 = _split(a)
    return _join(a0, fp6.neg(a1))


def cyclotomic_square(g):
    """Granger–Scott squaring, valid only in the cyclotomic subgroup (after
    the final exponentiation's easy part): 9 Fp2 squarings in one stacked
    call. With c0 = (a, b, c), c1 = (d, e, f):
        t0 = a² + ξe², t2 = d² + ξc², t4 = b² + ξf²,
        t6 = 2ae, t7 = 2cd, t8 = 2bf·ξ,
        c0' = (3t0−2a, 3t2−2b, 3t4−2c), c1' = (3t8+2d, 3t6+2e, 3t7+2f)."""
    g0, g1 = _split(g)
    a, b, c = fp6._split(g0)
    d, e, f = fp6._split(g1)
    W = fp.wrap
    sae, scd, sbf = fp.reduce_sums(torch.stack([a + e, c + d, b + f]))
    lhs = torch.stack([a, e, sae, c, d, scd, f, b, sbf], dim=0)
    s = fp2.mul(lhs, lhs)
    a2, e2, ae2, c2, d2, cd2, f2, b2, bf2 = (W(s[i]) for i in range(9))
    t6 = ae2 - a2 - e2
    t7 = cd2 - c2 - d2
    t8 = fp2.xi_s(bf2 - b2 - f2)
    t0 = fp2.xi_s(e2) + a2
    t2 = fp2.xi_s(c2) + d2
    t4 = fp2.xi_s(f2) + b2

    def three_t_minus_2x(t, x):
        return t.double() + t - W(x).double()

    def three_t_plus_2x(t, x):
        return t.double() + t + W(x).double()

    c0 = fp6.join_s(
        three_t_minus_2x(t0, a), three_t_minus_2x(t2, b), three_t_minus_2x(t4, c)
    )
    c1 = fp6.join_s(
        three_t_plus_2x(t8, d), three_t_plus_2x(t6, e), three_t_plus_2x(t7, f)
    )
    c0, c1 = fp.reduce_stack([c0, c1])
    return _join(c0, c1)


def inv(a):
    """(c0 + c1w)⁻¹ = (c0 − c1w)/(c0² − v·c1²)."""
    a0, a1 = _split(a)
    pair = torch.stack([a0, a1], dim=0)
    sq = fp6.mul(pair, pair)
    denom = fp6.sub(sq[0], fp6.mul_by_v(sq[1]))
    dinv = fp6.inv(denom)
    out = fp6.mul(pair, dinv[None])
    return _join(out[0], fp6.neg(out[1]))


def _associative_scan(fn, x):
    """Inclusive scan over axis 0 with the same pairing tree as
    `jax.lax.associative_scan` (odd/even recursion), so every product is
    taken of the same operands in the same order."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = _associative_scan(fn, fn(x[0:-1:2], x[1::2]))
    rest = x[2::2]
    if rest.shape[0] == 0:
        even = x[:1]
    else:
        even = torch.cat([x[:1], fn(odd[:-1] if n % 2 == 0 else odd, rest)])
    out = torch.empty_like(x)
    out[0::2] = even
    out[1::2] = odd
    return out


def batch_inv(a):
    """Element-wise inverse over axis 0 with Montgomery's product trick:
    ONE tower inversion plus prefix/suffix products,
        a_i⁻¹ = (Π_{j<i} a_j)·(Π_{j>i} a_j)·(Π_j a_j)⁻¹.
    All inputs must be nonzero (a zero lane poisons the batch)."""
    n = a.shape[0]
    if n == 1:
        return inv(a)
    inc = _associative_scan(mul, a)
    inc_rev = _associative_scan(mul, torch.flip(a, (0,)))
    ident = one((1,) + tuple(a.shape[1:-4]), a.device)
    pre = torch.cat([ident, inc[:-1]], dim=0)
    suf = torch.cat([torch.flip(inc_rev, (0,))[1:], ident], dim=0)
    total_inv = inv(inc[-1:])
    return mul(mul(pre, suf), total_inv)


def mul_by_line(f, l0, l1, l2):
    """f · (l0 + l1·w² + l2·w³), l_i ∈ Fp2: the sparse pairing-line update
    as 15 Fp2 products in one stacked call (A = (l0, l1, 0), B = (0, l2, 0),
    A + B = (l0, l1 + l2, 0))."""
    f0, f1 = _split(f)
    f00, f01, f02 = fp6._split(f0)
    f10, f11, f12 = fp6._split(f1)
    W = fp.wrap
    g0, g1, g2, s = fp.reduce_sums(
        torch.stack(torch.broadcast_tensors(f00 + f10, f01 + f11, f02 + f12, l1 + l2))
    )
    lhs = torch.stack(
        [f00, f02, f00, f01, f01, f02, f12, f10, f11, g0, g2, g0, g1, g1, g2], dim=0
    )
    l0, l1, l2 = torch.broadcast_tensors(l0, l1, l2)
    rhs = torch.stack([l0, l1, l1, l0, l1, l0, l2, l2, l2, l0, s, s, l0, s, l0], dim=0)
    rhs = torch.broadcast_to(rhs, lhs.shape)
    p = fp2.mul(lhs, rhs)
    t0 = fp6.join_s(
        W(p[0]) + fp2.xi_s(W(p[1])),
        W(p[2]) + W(p[3]),
        W(p[4]) + W(p[5]),
    )
    t1 = fp6.join_s(fp2.xi_s(W(p[6])), W(p[7]), W(p[8]))
    t2 = fp6.join_s(
        W(p[9]) + fp2.xi_s(W(p[10])),
        W(p[11]) + W(p[12]),
        W(p[13]) + W(p[14]),
    )
    c0 = t0 + fp6.mul_by_v_s(t1)
    c1 = t2 - t0 - t1
    c0, c1 = fp.reduce_stack([c0, c1])
    return _join(c0, c1)


# --- Frobenius -------------------------------------------------------------

def _gamma_const() -> np.ndarray:
    """(3, 6, 2, 32) Montgomery limbs: γ_i^(k) = ξ^(i(p^k−1)/6), k=1..3."""
    out = np.zeros((3, 6, 2, N_LIMBS), np.int32)
    for k in (1, 2, 3):
        for i, g in enumerate(_f.FROB_GAMMA[k]):
            out[k - 1, i, 0] = fp_to_mont_host(g.c0.n)
            out[k - 1, i, 1] = fp_to_mont_host(g.c1.n)
    return out


GAMMA = _gamma_const()


def _to_w(a):
    """(..., 2, 3, 2, 32) tower layout → (..., 6, 2, 32) w-coefficients."""
    a0, a1 = _split(a)
    d = [
        a0[..., 0, :, :], a1[..., 0, :, :],
        a0[..., 1, :, :], a1[..., 1, :, :],
        a0[..., 2, :, :], a1[..., 2, :, :],
    ]
    return torch.stack(d, dim=-3)


def _from_w(d):
    c0 = torch.stack([d[..., 0, :, :], d[..., 2, :, :], d[..., 4, :, :]], dim=-3)
    c1 = torch.stack([d[..., 1, :, :], d[..., 3, :, :], d[..., 5, :, :]], dim=-3)
    return _join(c0, c1)


def frobenius(a, power: int):
    """x^(p^power), power ∈ {1,2,3}: conj^power per w-coeff, then ·γ_i."""
    if power not in (1, 2, 3):
        raise ValueError("frobenius power must be 1, 2 or 3")
    d = _to_w(a)
    if power % 2 == 1:
        d = torch.cat([d[..., 0:1, :], fp.neg(d[..., 1:2, :])], dim=-2)
    gammas = fp.const(GAMMA, a.device)[power - 1]  # (6, 2, 32)
    d = fp2.mul(d, gammas)
    return _from_w(d)


def product_tree(fs):
    """log2-depth product over axis 0 (empty → 1)."""
    n = fs.shape[0]
    if n == 0:
        return one(tuple(fs.shape[1:-4]), fs.device)
    while n > 1:
        half = n // 2
        head = mul(fs[:half], fs[half : 2 * half])
        fs = head if n % 2 == 0 else torch.cat([head, fs[2 * half :]], 0)
        n = fs.shape[0]
    return fs[0]


def is_one(a):
    return eq(a, one(tuple(a.shape[:-4]), a.device))


def eq(a, b):
    return (fp.canonical(a) == fp.canonical(b)).flatten(-4).all(dim=-1)


def select(cond, a, b):
    return torch.where(cond[..., None, None, None, None], a, b)


def zero(batch: tuple = (), device=None):
    return torch.zeros(tuple(batch) + (2, 3, 2, N_LIMBS), dtype=torch.int32, device=device)


def one(batch: tuple = (), device=None):
    return _join(fp6.one(batch, device), fp6.zero(batch, device))
