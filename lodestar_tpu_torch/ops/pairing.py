"""Optimal ate pairing on BLS12-381 over int32 limb tensors.

The port of the JAX package's `ops/pairing.py`, limb for limb: Q stays on
the twist in homogeneous projective coordinates, lines are evaluated
through the untwist and scaled by factors the final exponentiation
annihilates, so the loop has no inversions. The Miller loop is a Python
loop over the 63 bits of |x| after the leading one (the addition step
runs on the 5 set bits); the final exponentiation is the easy part
(p⁶−1)(p²+1) and the HHT hard part, and computes pairing³ like the oracle
(harmless for == 1 checks since 3 ∤ r).

`miller_loop` (affine P and Q) is the entry that the JAX package sends to
its Pallas Miller kernel on a TPU; here it goes to K2
(`cuda_tower.miller_loop_kernel`) for CUDA tensors and to the plain loop
for CPU tensors. `miller_loop_proj_pq` (P and Q projective, the batch
verdicts' and the bisection tree's form, XLA in the JAX package) goes
the same way to K2p (`cuda_tower.miller_loop_proj_kernel`), and the final
exponentiation (`final_exponentiation_batch`, `final_exponentiation_one`,
the per-lane `final_exponentiation`) to K3-fe
(`cuda_tower.final_exp_kernel`). `miller_loop_projective` (projective P,
affine Q) has no caller in the port and always runs the plain loop.
"""

from __future__ import annotations

import torch

from ..bls.fields import X_PARAM
from . import fp, fp2, fp12
from .points import g2

X_ABS = abs(X_PARAM)
# MSB-first bits of |x| after the leading 1 (63 steps, 5 ones)
X_BITS_TAIL = [int(b) for b in bin(X_ABS)[3:]]


def _stack_mul(lhs, rhs):
    return g2._mulstack(lhs, rhs)


def _lift_fp(a):
    """Fp element (..., 32) → Fp2 with zero imaginary part."""
    return torch.stack([a, torch.zeros_like(a)], dim=-2)


def _line_and_double(t, xp_neg2, yp2, zp2, b3):
    """Fused tangent line + point doubling (three stacked Fp2 multiplies).

    Line (scaled by 2YZ²·w³, ×Zp for projective P):
        l0 = 3X³ − 2Y²Z,  l1 = 3X²Z·(−xp),  l2 = 2YZ²·yp.
    Double: RCB16 Algorithm 9 (a=0) on the twist."""
    x, y, z = t
    W = fp.wrap
    xx, yy, zz, yz, xy = _stack_mul([x, y, z, y, x], [x, y, z, z, y])
    xxx, yyz, xxz, yzz, t2b = _stack_mul([xx, yy, xx, yz, b3], [x, z, z, z, zz])
    y3s, two_yzz, three_xxz = fp.reduce_stack(
        [W(yy) + W(t2b), W(yzz).double(), W(xxz).double() + W(xxz)]
    )
    z8, l0, t0c = fp.reduce_stack(
        [W(yy).double().double().double(),
         W(xxx).double() + W(xxx) - W(yyz).double(),
         W(yy) - (W(t2b).double() + W(t2b))]
    )
    lhs = [three_xxz, two_yzz, t2b, yz, t0c, t0c]
    rhs = [xp_neg2, yp2, z8, z8, y3s, xy]
    if zp2 is not None:
        lhs.append(l0)
        rhs.append(zp2)
    out = _stack_mul(lhs, rhs)
    l1, l2, x3, z3, y3m, xt = out[:6]
    if zp2 is not None:
        l0 = out[6]
    ox, oy = fp.reduce_stack([W(xt).double(), W(x3) + W(y3m)])
    return l0, l1, l2, (ox, oy, z3)


def _line_and_add_projq(t, q_proj, xp_neg2, yp2, zp2, b3):
    """Fused chord line + full projective addition T + Q (Q projective),
    the line scaled by Zq² (annihilated by the final exponentiation):
    with θ' = Y·Zq − Yq·Z and H' = X·Zq − Xq·Z,
        l0 = θ'·Xq − Yq·H',  l1 = (Zq·θ')·(−xp),  l2 = (Zq·H')·yp."""
    x, y, z = t
    xq, yq, zq = q_proj
    W = fp.wrap
    sxy, sq = fp.reduce_sums(torch.stack([x + y, xq + yq]))
    t0, t1, t2, u, yzq, yqz, xzq, xqz = _stack_mul(
        [x, y, z, sxy, y, yq, x, xq],
        [xq, yq, zq, sq, zq, z, zq, z],
    )
    theta, h, t3, t4, y3p, x3 = fp.reduce_stack(
        [W(yzq) - W(yqz),
         W(xzq) - W(xqz),
         W(u) - W(t0) - W(t1),
         W(yzq) + W(yqz),
         W(xzq) + W(xqz),
         W(t0).double() + W(t0)]
    )
    t2b, th_xq, yq_h, thz, hz, y3 = _stack_mul(
        [b3, theta, yq, zq, zq, b3], [t2, xq, h, theta, h, y3p]
    )
    l0, z3, t1m = fp.reduce_stack(
        [W(th_xq) - W(yq_h), W(t1) + W(t2b), W(t1) - W(t2b)]
    )
    lhs = [t3, t4, y3, t1m, z3, x3, thz, hz]
    rhs = [t1m, y3, x3, z3, t4, t3, xp_neg2, yp2]
    if zp2 is not None:
        lhs.append(l0)
        rhs.append(zp2)
    out = _stack_mul(lhs, rhs)
    a, b, c, d, e, f, l1, l2 = out[:8]
    if zp2 is not None:
        l0 = out[8]
    ox, oy, oz = fp.reduce_stack([W(a) - W(b), W(c) + W(d), W(e) + W(f)])
    return l0, l1, l2, (ox, oy, oz)


def _line_and_add(t, q_aff, xp_neg2, yp2, zp2, b3):
    """Fused chord line + mixed addition T + Q (Q affine): with
    θ = Y − yq·Z and H = X − xq·Z, l0 = θ·xq − yq·H, l1 = θ·(−xp),
    l2 = H·yp (×Zp on l0 for projective P); RCB16 Algorithm 8 (a=0)."""
    x, y, z = t
    xq, yq = q_aff
    W = fp.wrap
    sxy, sq = fp.reduce_sums(torch.stack([x + y, xq + yq]))
    t0, t1, u, xqz, yqz, b3z = _stack_mul([x, y, sxy, xq, yq, b3], [xq, yq, sq, z, z, z])
    theta, h, t3, y3p, t4, x3, z3, t1m = fp.reduce_stack(
        [W(y) - W(yqz),
         W(x) - W(xqz),
         W(u) - W(t0) - W(t1),
         W(xqz) + W(x),
         W(yqz) + W(y),
         W(t0).double() + W(t0),
         W(t1) + W(b3z),
         W(t1) - W(b3z)]
    )
    th_xq, yq_h, l1, l2, y3 = _stack_mul([theta, yq, theta, h, b3], [xq, h, xp_neg2, yp2, y3p])
    l0 = fp2.sub(th_xq, yq_h)
    lhs = [t3, t4, y3, t1m, z3, x3]
    rhs = [t1m, y3, x3, z3, t4, t3]
    if zp2 is not None:
        lhs.append(l0)
        rhs.append(zp2)
    out = _stack_mul(lhs, rhs)
    a, b, c, d, e, f = out[:6]
    if zp2 is not None:
        l0 = out[6]
    ox, oy, oz = fp.reduce_stack([W(a) - W(b), W(c) + W(d), W(e) + W(f)])
    return l0, l1, l2, (ox, oy, oz)


def miller_loop(p_aff, q_aff):
    """f = conj(f_{|x|,Q}(P)) for P ∈ G1 affine (xp, yp) (..., 32) and Q ∈ G2
    affine (xq, yq) (..., 2, 32), batched over broadcast leading axes. Does
    not handle infinity: callers mask (see `pairing_check`). CUDA tensors
    run K2 (the JAX package's `LODESTAR_TPU_PALLAS_MILLER` resolves on on a
    TPU; the port hard-codes that), CPU tensors `_miller_loop_impl`."""
    from .cuda_tower import miller_loop_kernel

    return miller_loop_kernel(p_aff, q_aff)


def miller_loop_projective(p_proj, q_aff):
    """`miller_loop` with P = (Xp, Yp, Zp) homogeneous projective: equal
    after the final exponentiation up to the Zp subfield scale. Zp = 0
    lanes give garbage; callers mask them."""
    return _miller_loop_impl(p_proj[0], p_proj[1], p_proj[2], q_aff[0], q_aff[1], None)


def miller_loop_proj_pq(p_proj, q_proj):
    """f = conj(f_{|x|,Q}(P)) for P = (Xp, Yp, Zp) ∈ G1 and Q = (Xq, Yq, Zq)
    ∈ G2, both homogeneous projective: equal after the final
    exponentiation to the affine loop up to Zp/Zq subfield scales. Lanes
    with Zp = 0 or Zq = 0 give garbage; callers mask them. CUDA tensors
    run K2p, CPU tensors `_miller_loop_impl`."""
    from .cuda_tower import miller_loop_proj_kernel

    return miller_loop_proj_kernel(p_proj, q_proj)


def _miller_loop_impl(xp, yp, zp, xq, yq, zq):
    """The Miller loop over the bits of |x|; zp/zq None for affine P/Q."""
    batch = fp.broadcast_shapes(xp.shape[:-1], xq.shape[:-2])
    xp = torch.broadcast_to(xp, batch + xp.shape[-1:])
    yp = torch.broadcast_to(yp, batch + yp.shape[-1:])
    xq = torch.broadcast_to(xq, batch + xq.shape[-2:])
    yq = torch.broadcast_to(yq, batch + yq.shape[-2:])
    if zp is not None:
        zp = torch.broadcast_to(zp, batch + zp.shape[-1:])
    if zq is not None:
        zq = torch.broadcast_to(zq, batch + zq.shape[-2:])
    xp_neg2 = _lift_fp(fp.neg(xp))
    yp2 = _lift_fp(yp)
    zp2 = None if zp is None else _lift_fp(zp)
    b3 = g2.b3(xp.device)

    t = g2.from_affine(xq, yq) if zq is None else (xq, yq, zq)
    f = fp12.one(batch, xp.device)
    for bit in X_BITS_TAIL:
        l0, l1, l2, t = _line_and_double(t, xp_neg2, yp2, zp2, b3)
        f = fp12.mul_by_line(fp12.square(f), l0, l1, l2)
        if bit:
            if zq is None:
                a0, a1, a2, t = _line_and_add(t, (xq, yq), xp_neg2, yp2, zp2, b3)
            else:
                a0, a1, a2, t = _line_and_add_projq(t, (xq, yq, zq), xp_neg2, yp2, zp2, b3)
            f = fp12.mul_by_line(f, a0, a1, a2)
    return fp12.conj(f)


def _pow_x_abs(g):
    """g^|x| by square-and-multiply (63 cyclotomic squarings, 5 multiplies);
    g is cyclotomic (inside the hard part)."""
    acc = g
    for bit in X_BITS_TAIL:
        acc = fp12.cyclotomic_square(acc)
        if bit:
            acc = fp12.mul(acc, g)
    return acc


def _pow_x(g):
    """g^x, x negative: g^|x| then conjugate (cyclotomic inverse)."""
    return fp12.conj(_pow_x_abs(g))


def _hard_part(f):
    """HHT hard part on a cyclotomic element (computes pairing³)."""

    def pow_x_minus_1(g):
        return fp12.mul(_pow_x(g), fp12.conj(g))

    a = pow_x_minus_1(pow_x_minus_1(f))
    b = fp12.mul(_pow_x(a), fp12.frobenius(a, 1))
    c = fp12.mul(fp12.mul(_pow_x(_pow_x(b)), fp12.frobenius(b, 2)), fp12.conj(b))
    f3 = fp12.mul(fp12.mul(f, f), f)
    return fp12.mul(c, f3)


def final_exponentiation(f):
    """Per-lane final exponentiation: the easy part with each lane's own
    Fp12 inversion, then the HHT hard part (computes pairing³). CUDA
    tensors run K3-fe, which inverts per lane too."""
    from .cuda_tower import final_exp_kernel

    if f.device.type != "cpu":
        return final_exp_kernel(f)
    f = fp12.mul(fp12.conj(f), fp12.inv(f))  # f^(p⁶−1)
    f = fp12.mul(fp12.frobenius(f, 2), f)  # ^(p²+1): cyclotomic now
    return _hard_part(f)


def final_exponentiation_batch(fs):
    """Final exponentiation over axis 0: CUDA tensors run K3-fe (a Fermat
    inversion per lane), CPU tensors `_final_exponentiation_batch_impl`;
    the two give the same field elements."""
    from .cuda_tower import final_exp_kernel

    return final_exp_kernel(fs)


def _final_exponentiation_batch_impl(fs):
    """Final exponentiation over axis 0 with the easy part's Fp12 inversion
    shared by the batch (`fp12.batch_inv`). Zero lanes are safe: they are
    swapped for the identity before the shared inversion and their inverse
    forced back to zero, which is what the per-lane Fermat chain gives."""
    nz = ~(fp.canonical(fs) == 0).flatten(-4).all(dim=-1)
    batch = tuple(fs.shape[:-4])
    safe = fp12.select(nz, fs, fp12.one(batch, fs.device))
    inv = fp12.select(nz, fp12.batch_inv(safe), fp12.zero(batch, fs.device))
    f = fp12.mul(fp12.conj(fs), inv)  # f^(p⁶−1)
    f = fp12.mul(fp12.frobenius(f, 2), f)  # ^(p²+1): cyclotomic now
    return _hard_part(f)


def final_exponentiation_one(f):
    """Final exponentiation of ONE product through the batched entry (for
    n = 1 `batch_inv` is `inv`)."""
    return final_exponentiation_batch(f[None])[0]


def pairing(p_aff, q_aff):
    """e(P, Q)³ for affine P and Q (the final exponentiation's cube)."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def pairing_check(p_affs, q_affs, valid_mask):
    """Π_i e(P_i, Q_i) == 1 over batch axis 0, the multi-pairing check:
    P (xp, yp) and Q (xq, yq) with a leading batch axis, `valid_mask`
    (batch,) bool; False lanes contribute 1 (e(O, ·) = 1 for infinity)."""
    if p_affs[0].shape[0] == 0:
        return torch.tensor(True, device=p_affs[0].device)  # the empty product
    fs = miller_loop(p_affs, q_affs)
    fs = fp12.select(valid_mask, fs, fp12.one(tuple(fs.shape[:-4]), fs.device))
    return fp12.is_one(final_exponentiation_one(fp12.product_tree(fs)))
