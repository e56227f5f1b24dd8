"""Multi-scalar multiplication by bit-planes.

The grouped batch equation needs Σ_i k_i·P_i for 32-bit scalars k_i. The
sum is decomposed by bit-plane,

    Σ_i k_i·P_i = Σ_b 2^b · U_b,   U_b = Σ_{i: bit b of k_i} P_i,

with lanes grouped in fours and all 16 subset sums of each group
precomputed once (11 adds, shared by every plane); a plane gathers its
subset by the 4-bit mask and tree-reduces over groups. Generic over
`CurveOps` (G1 and G2), and limb for limb the JAX package's `ops/msm.py`.
"""

from __future__ import annotations

import torch


def _bsl(curve, a, sl):
    """Index the last batch axis (the one just before the coord axes)."""
    return a[(Ellipsis, sl) + (slice(None),) * curve.coord_ndim]


def tree_sum(curve, p):
    """log-depth complete-add reduction over the last batch axis:
    (X, Y, Z) of shape (..., n, *coord) → (..., *coord)."""
    axis = -1 - curve.coord_ndim
    n = p[0].shape[axis]
    while n > 1:
        half = n // 2
        a = tuple(_bsl(curve, c, slice(0, half)) for c in p)
        b = tuple(_bsl(curve, c, slice(half, 2 * half)) for c in p)
        s = curve.add(a, b)
        if n % 2:
            tail = tuple(_bsl(curve, c, slice(2 * half, n)) for c in p)
            s = tuple(torch.cat([sc, tc], dim=axis) for sc, tc in zip(s, tail))
        p = s
        n = p[0].shape[axis]
    return tuple(_bsl(curve, c, 0) for c in p)


def subset_table4(curve, p4):
    """All 16 subset sums of 4 projective points: (..., 4, *coord) →
    (..., 16, *coord); entry m sums the lanes whose bit is set in m (entry
    0 = infinity). 11 complete adds in 3 stacked calls."""
    cn = curve.coord_ndim
    pt = [tuple(_bsl(curve, c, k) for c in p4) for k in range(4)]

    def stk(pts):
        return tuple(torch.stack([q[i] for q in pts], dim=0) for i in range(3))

    def unstk(s, k):
        return tuple(c[k] for c in s)

    pr = curve.add(
        stk([pt[0], pt[0], pt[1], pt[0], pt[1], pt[2]]),
        stk([pt[1], pt[2], pt[2], pt[3], pt[3], pt[3]]),
    )
    p01, p02, p12, p03, p13, p23 = (unstk(pr, k) for k in range(6))
    tr = curve.add(stk([p01, p01, p02, p12]), stk([pt[2], pt[3], pt[3], pt[3]]))
    t012, t013, t023, t123 = (unstk(tr, k) for k in range(4))
    quad = curve.add(t012, pt[3])

    x0 = pt[0][0]
    inf = curve.infinity(x0.shape[: x0.ndim - cn], x0.device)
    entries = [
        inf, pt[0], pt[1], p01, pt[2], p02, p12, t012,
        pt[3], p03, p13, t013, p23, t023, t123, quad,
    ]
    return tuple(torch.stack([e[i] for e in entries], dim=-1 - cn) for i in range(3))


def masked_plane_sums(curve, p, bits):
    """Per-bit-plane masked sums U_t = Σ_l bits[..., l, t]·P_l.

    p: projective (..., L, *coord), L % 4 == 0; bits: (..., L, T) in {0,1}.
    Returns (T, ..., *coord) projective, plane axis leading."""
    cn = curve.coord_ndim
    L = p[0].shape[-1 - cn]
    T = bits.shape[-1]
    batch = tuple(p[0].shape[: -1 - cn])
    G = L // 4
    p4 = tuple(c.reshape(batch + (G, 4) + tuple(c.shape[-cn:])) for c in p)
    table = subset_table4(curve, p4)  # (..., G, 16, *coord)
    b4 = bits.reshape(batch + (G, 4, T)).to(torch.int64)
    idx = b4[..., 0, :] + (b4[..., 1, :] << 1) + (b4[..., 2, :] << 2) + (b4[..., 3, :] << 3)
    # (..., G, T) subset index per (group, plane) → gather (..., G, T, *coord)
    coord = tuple(table[0].shape[-cn:])
    gidx = idx.reshape(idx.shape + (1,) * cn).expand(idx.shape + coord)
    planes = tuple(torch.gather(c, -1 - cn, gidx) for c in table)
    # plane axis to the front, G last for the tree
    planes = tuple(torch.movedim(c, -1 - cn, 0) for c in planes)  # (T, ..., G, *coord)
    return tree_sum(curve, planes)


def horner_pow2(curve, planes):
    """Σ_t 2^t · planes[t] over the LEADING plane axis (LSB first):
    doublings and complete adds MSB first, from infinity."""
    cn = curve.coord_ndim
    x0 = planes[0]
    batch = tuple(x0.shape[1 : x0.ndim - cn])
    acc = curve.infinity(batch, x0.device)
    for t in reversed(range(x0.shape[0])):
        acc = curve.add(curve.double(acc), tuple(c[t] for c in planes))
    return acc
