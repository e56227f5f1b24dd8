"""Fp6 = Fp2[v]/(v³ − ξ) on int32 limb tensors.

Element shape (..., 3, 2, 32): axis −3 indexes (c0, c1, c2) of
c0 + c1·v + c2·v². The 6-product Karatsuba multiplication stacks into ONE
fp2.mul call, as in the JAX package's `ops/fp6.py`.
"""

from __future__ import annotations

import torch

from . import fp, fp2
from .limbs import N_LIMBS


def _split(a):
    return a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]


def _join(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


def add(a, b):
    return fp.add(a, b)


def sub(a, b):
    return fp.sub(a, b)


def neg(a):
    return fp.neg(a)


def _bcast(a, b):
    batch = fp.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    return (
        torch.broadcast_to(a, batch + a.shape[-3:]),
        torch.broadcast_to(b, batch + b.shape[-3:]),
    )


def mul(a, b):
    """Toom/Karatsuba interpolation: 6 Fp2 products, one stacked call.

    c0 = v0 + ξ((a1+a2)(b1+b2) − v1 − v2)
    c1 = (a0+a1)(b0+b1) − v0 − v1 + ξ·v2
    c2 = (a0+a2)(b0+b2) − v0 − v2 + v1
    """
    a, b = _bcast(a, b)
    a0, a1, a2 = _split(a)
    b0, b1, b2 = _split(b)
    sa12, sa01, sa02, sb12, sb01, sb02 = fp.reduce_sums(
        torch.stack([a1 + a2, a0 + a1, a0 + a2, b1 + b2, b0 + b1, b0 + b2])
    )
    big_a = torch.stack([a0, a1, a2, sa12, sa01, sa02], dim=0)
    big_b = torch.stack([b0, b1, b2, sb12, sb01, sb02], dim=0)
    v = fp2.mul(big_a, big_b)
    v0, v1, v2, v12, v01, v02 = v[0], v[1], v[2], v[3], v[4], v[5]
    W = fp.wrap
    c0 = W(v0) + fp2.xi_s(W(v12) - W(v1) - W(v2))
    c1 = W(v01) - W(v0) - W(v1) + fp2.xi_s(W(v2))
    c2 = W(v02) - W(v0) - W(v2) + W(v1)
    c0, c1, c2 = fp.reduce_stack([c0, c1, c2])
    return _join(c0, c1, c2)


def square(a):
    return mul(a, a)


def mul_by_v(a):
    """v·(c0 + c1v + c2v²) = ξc2 + c0·v + c1·v²."""
    a0, a1, a2 = _split(a)
    return _join(fp2.mul_by_xi(a2), a0, a1)


def mul_by_v_s(s: "fp.Sum") -> "fp.Sum":
    """`mul_by_v` on a bounds-tracked Sum over an (…, 3, 2, 32) block."""
    x2 = fp.Sum(s.cols[..., 2, :, :], s.lo, s.hi)
    xi2 = fp2.xi_s(x2)
    cols = torch.stack([xi2.cols, s.cols[..., 0, :, :], s.cols[..., 1, :, :]], dim=-3)
    return fp.Sum(cols, min(xi2.lo, s.lo), max(xi2.hi, s.hi))


def join_s(s0: "fp.Sum", s1: "fp.Sum", s2: "fp.Sum") -> "fp.Sum":
    """Stack three fp2-block Sums into one fp6-block Sum."""
    cols = torch.stack([s0.cols, s1.cols, s2.cols], dim=-3)
    return fp.Sum(cols, min(s0.lo, s1.lo, s2.lo), max(s0.hi, s1.hi, s2.hi))


def mul_fp2(a, k):
    """Fp6 × Fp2 scalar: k has shape (..., 2, 32)."""
    return fp2.mul(a, k[..., None, :, :])


def inv(a):
    """Standard tower inversion (the oracle's Fq6.inverse)."""
    a0, a1, a2 = _split(a)
    p = fp2.mul(
        torch.stack([a0, a1, a2, a0, a1, a0], dim=0),
        torch.stack([a0, a2, a2, a1, a1, a2], dim=0),
    )
    sq0, p12, sq2, p01, sq1, p02 = p[0], p[1], p[2], p[3], p[4], p[5]
    t0 = fp2.sub(sq0, fp2.mul_by_xi(p12))  # a0² − ξ a1a2
    t1 = fp2.sub(fp2.mul_by_xi(sq2), p01)  # ξ a2² − a0a1
    t2 = fp2.sub(sq1, p02)  # a1² − a0a2
    q = fp2.mul(torch.stack([a0, a2, a1], dim=0), torch.stack([t0, t1, t2], dim=0))
    denom = fp2.add(q[0], fp2.mul_by_xi(fp2.add(q[1], q[2])))
    dinv = fp2.inv(denom)
    out = fp2.mul(torch.stack([t0, t1, t2], dim=0), dinv[None])
    return _join(out[0], out[1], out[2])


def is_zero(a):
    return (fp.canonical(a) == 0).flatten(-3).all(dim=-1)


def eq(a, b):
    return (fp.canonical(a) == fp.canonical(b)).flatten(-3).all(dim=-1)


def select(cond, a, b):
    return torch.where(cond[..., None, None, None], a, b)


def zero(batch: tuple = (), device=None):
    return torch.zeros(tuple(batch) + (3, 2, N_LIMBS), dtype=torch.int32, device=device)


def one(batch: tuple = (), device=None):
    return _join(fp2.one(batch, device), fp2.zero(batch, device), fp2.zero(batch, device))
