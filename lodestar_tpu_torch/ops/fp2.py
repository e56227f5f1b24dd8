"""Fp2 = Fp[u]/(u²+1) on int32 limb tensors.

An Fp2 element is a (..., 2, 32) int32 tensor: axis −2 indexes (c0, c1)
of c0 + c1·u, axis −1 is the 12-bit limb axis. The Karatsuba product runs
its three base-field products as ONE stacked multiply (or, on the lazy
path, one stacked convolution and one stacked reduction), as the JAX
package's `ops/fp2.py` does, limb for limb.
"""

from __future__ import annotations

import torch

from . import fp
from .limbs import N_LIMBS

# The JAX package gates lazy reduction on LODESTAR_TPU_LAZY_FP2 (default
# on) and LODESTAR_TPU_LAZY_FP2_MAX_ELEMS (default 2^24); the port reads no
# environment and keeps those defaults, so the same shapes take the same
# branch.
LAZY_MAX_ELEMS = 1 << 24


def _split(a):
    return a[..., 0, :], a[..., 1, :]


def _join(c0, c1):
    return torch.stack([c0, c1], dim=-2)


def add(a, b):
    return fp.add(a, b)


reduce_sums = fp.reduce_sums
two_p = fp.two_p


def sub(a, b):
    return fp.sub(a, b)


def neg(a):
    return fp.neg(a)


def double(a):
    return fp.add(a, a)


def _bcast(a, b):
    batch = fp.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return (
        torch.broadcast_to(a, batch + a.shape[-2:]),
        torch.broadcast_to(b, batch + b.shape[-2:]),
    )


def _use_lazy(big_a) -> bool:
    """Lazy reduction doubles the live width (64 columns): stacks above
    LAZY_MAX_ELEMS elements take the 3-multiply form."""
    return big_a.numel() <= LAZY_MAX_ELEMS


def mul(a, b):
    """Karatsuba product. Lazy path: 3 convolutions + 2 Montgomery
    reductions; c0's subtraction is offset by 4p² and c1's by 8p² (the
    operand sums may be reduced by 2p), keeping the values non-negative."""
    a, b = _bcast(a, b)
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    big_a = torch.stack([a0, a1, fp.add(a0, a1)], dim=0)
    big_b = torch.stack([b0, b1, fp.add(b0, b1)], dim=0)
    if _use_lazy(big_a):
        cols = fp.conv_cols(big_a, big_b)
        p0, p1, p2 = cols[0], cols[1], cols[2]
        c0_cols = p0 - p1 + fp.const(fp.FOUR_P2_COLS, cols.device)
        c1_cols = p2 - p0 - p1 + fp.const(fp.EIGHT_P2_COLS, cols.device)
        out = fp.redc_cols(torch.stack([c0_cols, c1_cols], dim=0))
        return _join(out[0], out[1])
    p = fp.mul(big_a, big_b)
    p0, p1, p2 = p[0], p[1], p[2]
    c0 = fp.sub(p0, p1)
    c1 = fp.sub(p2, fp.add(p0, p1))
    return _join(c0, c1)


def square(a):
    """(a0+a1u)²: c0 = (a0+a1)(a0−a1), c1 = 2·a0·a1."""
    a0, a1 = _split(a)
    big_a = torch.stack([fp.add(a0, a1), a0], dim=0)
    big_b = torch.stack([fp.sub(a0, a1), fp.add(a1, a1)], dim=0)
    if _use_lazy(big_a):
        out = fp.redc_cols(fp.conv_cols(big_a, big_b))
        return _join(out[0], out[1])
    p = fp.mul(big_a, big_b)
    return _join(p[0], p[1])


def mul_fp(a, k):
    """Fp2 × Fp scalar: k has shape (..., 32)."""
    return fp.mul(a, k[..., None, :])


def mul_by_xi(a):
    """Multiply by ξ = 1 + u: (c0 − c1) + (c0 + c1)u."""
    a0, a1 = _split(a)
    return _join(fp.sub(a0, a1), fp.add(a0, a1))


def xi_s(s: "fp.Sum") -> "fp.Sum":
    """ξ·(expression) on a bounds-tracked Sum over an (…, 2, 32) block."""
    c0 = s.cols[..., 0, :]
    c1 = s.cols[..., 1, :]
    cols = torch.stack([c0 - c1, c0 + c1], dim=-2)
    return fp.Sum(cols, min(s.lo - s.hi, 2 * s.lo), max(s.hi - s.lo, 2 * s.hi))


def conj(a):
    a0, a1 = _split(a)
    return _join(a0, fp.neg(a1))


def inv(a):
    """(a0 − a1u)/(a0² + a1²). Zero maps to zero."""
    a0, a1 = _split(a)
    pair = torch.stack([a0, a1], dim=0)
    p = fp.mul(pair, pair)
    norm_inv = fp.inv(fp.add(p[0], p[1]))
    q = fp.mul(pair, norm_inv[None])
    return _join(q[0], fp.neg(q[1]))


def is_zero(a):
    return torch.all(fp.canonical(a) == 0, dim=-1).all(dim=-1)


def eq(a, b):
    return torch.all(fp.canonical(a) == fp.canonical(b), dim=-1).all(dim=-1)


def select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


def zero(batch: tuple = (), device=None):
    return torch.zeros(tuple(batch) + (2, N_LIMBS), dtype=torch.int32, device=device)


def one(batch: tuple = (), device=None):
    return _join(fp.one_mont(batch, device), fp.zero(batch, device))
