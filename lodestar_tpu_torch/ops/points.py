"""Elliptic-curve point ops in homogeneous projective coordinates.

Generic over the coordinate field: the same code drives G1 (field =
`fp`, coordinates (..., 32)) and G2 (field = `fp2`, (..., 2, 32)). Points
are (X, Y, Z) tuples; infinity is (0, 1, 0) and is handled by the
COMPLETE addition formulas of Renes–Costello–Batina 2016 (a = 0), so
there are no branches. Each formula evaluates its independent products
as one stacked field multiply and its independent sums as one stacked
carry, in the same order as the JAX package's `ops/points.py`, so the
results agree limb for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls import curve as _curve
from ..bls.fields import Fq, Fq2
from . import fp, fp2
from .io_host import fq2_to_limbs, fq_to_limbs


class CurveOps:
    """Point arithmetic for one curve over field module `F`.

    `b3` is 3·b (the curve constant) as a numpy limb array; `coord_ndim`
    is the number of trailing axes of one coordinate (1 for Fp, 2 for Fp2).
    """

    def __init__(self, F, b3: np.ndarray, coord_ndim: int):
        self.F = F
        self.b3_np = b3
        self.coord_ndim = coord_ndim

    def b3(self, device) -> torch.Tensor:
        return fp.const(self.b3_np, device)

    # -- constructors -------------------------------------------------------

    def infinity(self, batch: tuple = (), device=None):
        F = self.F
        return (F.zero(batch, device), F.one(batch, device), F.zero(batch, device))

    def from_affine(self, x, y):
        batch = x.shape[: x.ndim - self.coord_ndim]
        return (x, y, self.F.one(batch, x.device))

    # -- predicates ---------------------------------------------------------

    def is_infinity(self, p):
        return self.F.is_zero(p[2])

    def eq(self, p, q):
        """Projective equality: X1·Z2 == X2·Z1 and Y1·Z2 == Y2·Z1 (plus
        matching infinity flags)."""
        x1, y1, z1 = p
        x2, y2, z2 = q
        cross_x = self.F.eq(self.F.mul(x1, z2), self.F.mul(x2, z1))
        cross_y = self.F.eq(self.F.mul(y1, z2), self.F.mul(y2, z1))
        inf1, inf2 = self.is_infinity(p), self.is_infinity(q)
        both_inf = inf1 & inf2
        return both_inf | (cross_x & cross_y & ~inf1 & ~inf2)

    def select(self, cond, p, q):
        s = self.F.select
        return (s(cond, p[0], q[0]), s(cond, p[1], q[1]), s(cond, p[2], q[2]))

    # -- group law (complete, branchless) -----------------------------------

    def _mulstack(self, lhs, rhs):
        """One stacked field multiply over a new leading axis (operands
        broadcast to a common shape first, so constants like b3 ride
        along)."""
        shape = fp.broadcast_shapes(*(a.shape for a in lhs), *(b.shape for b in rhs))
        lhs = torch.stack([torch.broadcast_to(a, shape) for a in lhs], dim=0)
        rhs = torch.stack([torch.broadcast_to(b, shape) for b in rhs], dim=0)
        out = self.F.mul(lhs, rhs)
        return list(out.unbind(0))

    def _addstack(self, exprs):
        """One stacked `reduce_sums` over a stage's independent add/sub
        column expressions (each with value < 4p)."""
        shape = fp.broadcast_shapes(*(e.shape for e in exprs))
        out = self.F.reduce_sums(
            torch.stack([torch.broadcast_to(e, shape) for e in exprs], dim=0)
        )
        return list(out.unbind(0))

    def add(self, p, q):
        """RCB16 Algorithm 7 (a=0): complete projective addition, as 3
        stacked multiplies (6+2+6 products) and 4 stacked add-scans."""
        F = self.F
        x1, y1, z1 = p
        x2, y2, z2 = q
        b3 = self.b3(x1.device)
        TP = F.two_p(x1)
        xy1, yz1, xz1, xy2, yz2, xz2 = self._addstack(
            [x1 + y1, y1 + z1, x1 + z1, x2 + y2, y2 + z2, x2 + z2]
        )
        t0, t1, t2, u, v, w = self._mulstack(
            [x1, y1, z1, xy1, yz1, xz1], [x2, y2, z2, xy2, yz2, xz2]
        )
        s01, s12, s02, t00 = self._addstack([t0 + t1, t1 + t2, t0 + t2, t0 + t0])
        t3, t4, y3p, x3 = self._addstack(
            [u - s01 + TP, v - s12 + TP, w - s02 + TP, t00 + t0]
        )
        t2b, y3 = self._mulstack([b3, b3], [t2, y3p])
        z3, t1 = self._addstack([t1 + t2b, t1 - t2b + TP])
        a, b, c, d, e, f = self._mulstack(
            [t3, t4, y3, t1, z3, x3], [t1, y3, x3, z3, t4, t3]
        )
        ox, oy, oz = self._addstack([a - b + TP, c + d, e + f])
        return (ox, oy, oz)

    def double(self, p):
        """RCB16 Algorithm 9 (a=0): complete projective doubling."""
        F = self.F
        x, y, z = p
        b3 = self.b3(x.device)
        TP = F.two_p(x)
        t0, t1, t2, txy = self._mulstack([y, y, z, x], [y, z, z, y])
        t2b = F.mul(b3, t2)
        z2d, y3s, t1c = self._addstack([t0 + t0, t0 + t2b, t2b + t2b])
        z4d, t2c = self._addstack([z2d + z2d, t1c + t2b])
        z8, t0c = self._addstack([z4d + z4d, t0 - t2c + TP])  # z8 = 8y²
        x3, z3, y3, xt = self._mulstack([t2b, t1, t0c, t0c], [z8, z8, y3s, txy])
        oy, ox = self._addstack([x3 + y3, xt + xt])
        return (ox, oy, z3)

    def add_mixed(self, p, q_affine):
        """RCB16 Algorithm 8 (a=0): complete mixed addition with Z2 = 1. The
        affine operand cannot encode infinity; callers mask it."""
        F = self.F
        x1, y1, z1 = p
        x2, y2 = q_affine
        b3 = self.b3(x1.device)
        TP = F.two_p(x1)
        xy1, xy2 = self._addstack([x1 + y1, x2 + y2])
        t0, t1, u, xz, yz, t2b = self._mulstack(
            [x1, y1, xy1, x2, y2, b3], [x2, y2, xy2, z1, z1, z1]
        )
        s01, t00, y3p, t4, z3, t1m = self._addstack(
            [t0 + t1, t0 + t0, xz + x1, yz + y1, t1 + t2b, t1 - t2b + TP]
        )
        t3, x3 = self._addstack([u - s01 + TP, t00 + t0])
        y3 = F.mul(b3, y3p)
        a, b, c, d, e, f = self._mulstack(
            [t3, t4, y3, t1m, z3, x3], [t1m, y3, x3, z3, t4, t3]
        )
        ox, oy, oz = self._addstack([a - b + TP, c + d, e + f])
        return (ox, oy, oz)

    def neg(self, p):
        return (p[0], self.F.neg(p[1]), p[2])

    # -- scalar multiplication ----------------------------------------------

    def scalar_mul_bits(self, bits, q_affine):
        """[k]Q for affine Q, k as (..., nbits) int32 bits, MSB first:
        double-and-add over every bit with the add taken by a select (the
        JAX package's `lax.scan` as a Python loop), so the cost does not
        depend on the scalars."""
        nbits = bits.shape[-1]
        cn = self.coord_ndim
        xq, yq = q_affine
        batch = fp.broadcast_shapes(bits.shape[:-1], xq.shape[: xq.ndim - cn])
        xq = torch.broadcast_to(xq, batch + tuple(xq.shape[xq.ndim - cn:]))
        yq = torch.broadcast_to(yq, batch + tuple(yq.shape[yq.ndim - cn:]))
        bits = torch.broadcast_to(bits, batch + (nbits,))
        acc = self.infinity(batch, xq.device)
        for j in range(nbits):
            acc = self.double(acc)
            added = self.add_mixed(acc, (xq, yq))
            acc = self.select(bits[..., j] != 0, added, acc)
        return acc

    def scalar_mul_windowed(self, bits, q_affine, window: int = 4):
        """[k]Q by fixed 2^w windows, MSB first: the contract of
        `scalar_mul_bits` (the JAX package's `ops/points.py:214`). The
        table T[d] = d·Q (T[0] infinity, T[1] = Q, then 2^w − 2 mixed
        additions) is stacked on a leading digit axis; each window doubles
        w times and adds T[digit] with the complete addition, the lookup a
        chain of selects, so the cost does not depend on the scalars. A bit
        count that is not a multiple of `window` takes the bit ladder. No
        path of the port calls it (the JAX package measured it slower than
        the ladder on its TPU)."""
        nbits = bits.shape[-1]
        if nbits % window:
            return self.scalar_mul_bits(bits, q_affine)
        cn = self.coord_ndim
        xq, yq = q_affine
        batch = fp.broadcast_shapes(bits.shape[:-1], xq.shape[: xq.ndim - cn])
        coord = tuple(xq.shape[xq.ndim - cn:])
        xq = torch.broadcast_to(xq, batch + coord)
        yq = torch.broadcast_to(yq, batch + coord)
        bits = torch.broadcast_to(bits, batch + (nbits,))
        weights = torch.tensor([1 << (window - 1 - i) for i in range(window)],
                               dtype=bits.dtype, device=bits.device)
        # (n_windows, ...batch) digits, MSB first
        digits = torch.movedim(
            (bits.reshape(batch + (nbits // window, window)) * weights).sum(-1), -1, 0)
        entries = [self.infinity(batch, xq.device), self.from_affine(xq, yq)]
        for _ in range(2, 1 << window):
            entries.append(self.add_mixed(entries[-1], (xq, yq)))
        table = tuple(torch.stack([e[i] for e in entries], dim=0) for i in range(3))
        acc = self.infinity(batch, xq.device)
        for digit in digits:
            for _ in range(window):
                acc = self.double(acc)
            entry = tuple(t[0] for t in table)
            for d in range(1, 1 << window):
                entry = self.select(digit == d, tuple(t[d] for t in table), entry)
            acc = self.add(acc, entry)
        return acc

    # -- normalization -------------------------------------------------------

    def to_affine(self, p):
        """(X/Z, Y/Z) with one batched inversion of Z (the JAX package's
        `ops/points.py:277`); infinity maps to (0, 0), so callers mask it
        with `is_infinity`. No path of the port calls it."""
        zinv = self.F.inv(p[2])
        return (self.F.mul(p[0], zinv), self.F.mul(p[1], zinv))


g1 = CurveOps(fp, fq_to_limbs(Fq(12)), coord_ndim=1)  # 3·4
g2 = CurveOps(fp2, fq2_to_limbs(Fq2.from_ints(12, 12)), coord_ndim=2)  # 3·4(1+u)

# generators as affine limb constants (numpy; host-computed)
_g1_gen = _curve.PointG1.generator().to_affine()
G1_GEN_X = fq_to_limbs(_g1_gen[0])
G1_GEN_Y = fq_to_limbs(_g1_gen[1])


# --- ψ endomorphism on G2 ---------------------------------------------------
#
# ψ acts on G2 as multiplication by the BLS parameter z: ψ(x, y) =
# (c_x·conj(x), c_y·conj(y)). The grouped verifier splits its 64-bit
# random coefficients as r = a + z·b and trades half of every scalar
# combination for one ψ application (two Fp2 multiplies).

PSI_CX_L = fq2_to_limbs(_curve.PSI_CX)
PSI_CY_L = fq2_to_limbs(_curve.PSI_CY)


def g2_psi(p):
    """ψ of a projective G2 point: (c_x·conj(X), c_y·conj(Y), conj(Z))."""
    x, y, z = p
    cx = fp.const(PSI_CX_L, x.device)
    cy = fp.const(PSI_CY_L, x.device)
    out = fp2.mul(
        torch.stack([fp2.conj(x), fp2.conj(y)], dim=0),
        torch.stack([cx.expand(x.shape), cy.expand(y.shape)], dim=0),
    )
    return (out[0], out[1], fp2.conj(z))


def _neg_g1_pow2_table(nbits: int):
    """Affine limb table of −[2^b]·g1, b = 0..nbits−1 (host-computed): the
    batch verifiers pair each signature bit-plane against one entry (32
    planes per GLS half in the grouped verdicts, 64 in the flat one)."""
    xs, ys = [], []
    cur = _curve.PointG1.generator()
    for _ in range(nbits):
        aff = cur.to_affine()
        xs.append(fq_to_limbs(aff[0]))
        ys.append(fq_to_limbs(-aff[1]))
        cur = cur.double()
    return np.stack(xs), np.stack(ys)


NEG_G1_POW2_64_X, NEG_G1_POW2_64_Y = _neg_g1_pow2_table(64)
NEG_G1_POW2_X, NEG_G1_POW2_Y = NEG_G1_POW2_64_X[:32], NEG_G1_POW2_64_Y[:32]
