"""The benchmark's plain reference: BLS12-381 signature-set verification in
Python integers, written from the specifications alone.

- Curves and fields: BLS12-381 (E: y² = x³ + 4 over Fp, E': y² = x³ +
  4(1+i) over Fp2 = Fp[i]/(i² + 1), Fp6 = Fp2[v]/(v³ − (1+i)), Fp12 =
  Fp6[w]/(w² − v)); points compressed as ZCash's serialisation does.
- Hash to G2: RFC 9380, suite BLS12381G2_XMD:SHA-256_SSWU_RO_ with the
  Ethereum proof-of-possession DST: expand_message_xmd, hash_to_field,
  the simplified SWU map onto the 3-isogenous curve, the isogeny in its
  Vélu form, and clear_cofactor as RFC 9380 Appendix G.3.
- Pairing: the optimal ate Miller loop over |x| = 0xd201000000010000 in
  affine coordinates on E', each line untwisted into Fp12 and multiplied
  in; the final exponentiation as (p⁶ − 1) by conjugate and inverse,
  then a plain square-and-multiply by (p⁶ + 1)/r.

A set (pk, m, sig) verifies when pk decodes to a point other than
infinity, sig decodes to a point of G2 and e(pk, H(m)) = e(g1, sig).
Public keys are registry keys, KeyValidated when they were deposited
(and the block cell's aggregate keys are sums of such keys), so, like the
serving path, the reference does not test them for G1 membership.

`verify_calls` decides many calls at once: every set gets a 64-bit random
coefficient from the caller's generator, and a group of calls passes when
Π_m e(Σ r·pk, H(m)) · e(−g1, Σ r·sig) = 1 (the sets of one signing root
share their Miller loop). A failed group is halved until single calls are
left. A group of valid sets always passes; a group holding an invalid set
passes with probability at most 2⁻⁶⁴.

Nothing here imports the program; the only dependencies are `hashlib`.
"""

from __future__ import annotations

import hashlib

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_ABS = 0xD201000000010000  # |x|; the curve parameter x is negative
HALF_P = (P - 1) // 2
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

# ---------------------------------------------------------------- Fp, Fp2


def fp_sqrt(a: int):
    """A square root of a in Fp (p ≡ 3 mod 4), or None."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


ZERO2 = (0, 0)
ONE2 = (1, 0)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def f2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def f2_scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    a0, a1 = a
    n = pow(a0 * a0 + a1 * a1, -1, P)
    return (a0 * n % P, -a1 * n % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_mul_xi(a):
    """a · (1 + i)."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def f2_pow(a, e: int):
    out = ONE2
    for bit in bin(e)[2:]:
        out = f2_sqr(out)
        if bit == "1":
            out = f2_mul(out, a)
    return out


def f2_sqrt(a):
    """A square root of a in Fp2 through square roots in Fp, or None."""
    a0, a1 = a
    if a1 == 0:
        r = fp_sqrt(a0)
        if r is not None:
            return (r, 0)
        r = fp_sqrt(-a0 % P)
        return (0, r) if r is not None else None
    s = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if s is None:
        return None
    half = (P + 1) // 2
    x0 = fp_sqrt((a0 + s) * half % P)
    if x0 is None:
        x0 = fp_sqrt((a0 - s) * half % P)
        if x0 is None:
            return None
    x = (x0, a1 * pow(2 * x0, -1, P) % P)
    return x if f2_sqr(x) == (a0 % P, a1 % P) else None


def f2_sgn0(a) -> int:
    """RFC 9380 sgn0 for Fp2."""
    return (a[0] & 1) | (int(a[0] == 0) & (a[1] & 1))


# ---------------------------------------------------------------- Fp6, Fp12

ZERO6 = (ZERO2, ZERO2, ZERO2)
ONE6 = (ONE2, ZERO2, ZERO2)
ONE12 = (ONE6, ZERO6)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_v(a):
    """a · v."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_mul_01(a, b0, b1):
    """a · (b0 + b1·v)."""
    a0, a1, a2 = a
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    c0 = f2_add(t0, f2_mul_xi(f2_mul(a2, b1)))
    c1 = f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1))
    c2 = f2_add(f2_mul(a2, b0), t1)
    return (c0, c1, c2)


def f6_mul_v_fp(a, k: int):
    """a · (k·v) for k in Fp."""
    return (f2_mul_xi(f2_scale(a[2], k)), f2_scale(a[0], k), f2_scale(a[1], k))


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a0, c0), f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (f6_add(t0, f6_mul_v(t1)), c1)


def f12_sqr(a):
    a0, a1 = a
    t = f6_mul(a0, a1)
    c0 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_v(a1))), f6_add(t, f6_mul_v(t)))
    return (c0, f6_add(t, t))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    d = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1))))
    return (f6_mul(a0, d), f6_neg(f6_mul(a1, d)))


def f12_mul_line(f, l0, l1, yp: int):
    """f · ((l0 + l1·v) + (yp·v)·w), the sparse untwisted line."""
    f0, f1 = f
    return (f6_add(f6_mul_01(f0, l0, l1), f6_mul_v(f6_mul_v_fp(f1, yp))),
            f6_add(f6_mul_v_fp(f0, yp), f6_mul_01(f1, l0, l1)))


_HARD = (P ** 6 + 1) // R
assert _HARD * R == P ** 6 + 1


def final_exp_is_one(f) -> bool:
    """f^((p¹² − 1)/r) == 1."""
    g = f12_mul(f12_conj(f), f12_inv(f))  # f^(p⁶ − 1): unitary from here on
    out = ONE12
    for bit in bin(_HARD)[2:]:
        out = f12_sqr(out)
        if bit == "1":
            out = f12_mul(out, g)
    return out == ONE12


# ---------------------------------------------------------------- points

# Jacobian points as (X, Y, Z) over a field given by its operations; Z
# zero is infinity. G1 over Fp, G2 over Fp2.


class _Field:
    def __init__(self, add, sub, mul, sqr, zero, one, inv):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.zero, self.one, self.inv = zero, one, inv


FP = _Field(lambda a, b: (a + b) % P, lambda a, b: (a - b) % P, lambda a, b: a * b % P,
            lambda a: a * a % P, 0, 1, lambda a: pow(a, -1, P))
FP2 = _Field(f2_add, f2_sub, f2_mul, f2_sqr, ZERO2, ONE2, f2_inv)


def jac_dbl(F, p):
    x, y, z = p
    if z == F.zero or y == F.zero:
        return (F.one, F.one, F.zero)
    a = F.sqr(x)
    b = F.sqr(y)
    c = F.sqr(b)
    d = F.sub(F.sqr(F.add(x, b)), F.add(a, c))
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    x3 = F.sub(F.sqr(e), F.add(d, d))
    c8 = F.add(c, c)
    c8 = F.add(c8, c8)
    c8 = F.add(c8, c8)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    yz = F.mul(y, z)
    return (x3, y3, F.add(yz, yz))


def jac_add(F, p, q):
    if p[2] == F.zero:
        return q
    if q[2] == F.zero:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = F.sqr(z1)
    z2z2 = F.sqr(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2, z2z2))
    s2 = F.mul(y2, F.mul(z1, z1z1))
    if u1 == u2:
        return jac_dbl(F, p) if s1 == s2 else (F.one, F.one, F.zero)
    h = F.sub(u2, u1)
    i = F.sqr(F.add(h, h))
    j = F.mul(h, i)
    r = F.sub(s2, s1)
    r = F.add(r, r)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.sqr(r), j), F.add(v, v))
    s1j = F.mul(s1, j)
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.add(s1j, s1j))
    z3 = F.mul(F.sub(F.sqr(F.add(z1, z2)), F.add(z1z1, z2z2)), h)
    return (x3, y3, z3)


def jac_neg(F, p):
    return (p[0], F.sub(F.zero, p[1]), p[2])


def jac_mul(F, p, k: int):
    """[k]p for k ≥ 0, double-and-add."""
    out = (F.one, F.one, F.zero)
    for bit in bin(k)[2:]:
        out = jac_dbl(F, out)
        if bit == "1":
            out = jac_add(F, out, p)
    return out


def jac_affine(F, p):
    """(x, y), or None at infinity."""
    if p[2] == F.zero:
        return None
    zi = F.inv(p[2])
    zi2 = F.sqr(zi)
    return (F.mul(p[0], zi2), F.mul(p[1], F.mul(zi2, zi)))


def jac_eq(F, p, q) -> bool:
    if p[2] == F.zero or q[2] == F.zero:
        return p[2] == q[2]
    z1z1 = F.sqr(p[2])
    z2z2 = F.sqr(q[2])
    return (F.mul(p[0], z2z2) == F.mul(q[0], z1z1)
            and F.mul(p[1], F.mul(q[2], z2z2)) == F.mul(q[1], F.mul(p[2], z1z1)))


# ψ, the untwist-Frobenius-twist endomorphism of E'
_PSI_X = f2_inv(f2_pow((1, 1), (P - 1) // 3))
_PSI_Y = f2_inv(f2_pow((1, 1), (P - 1) // 2))


def g2_psi(p):
    x, y, z = p
    return (f2_mul(f2_conj(x), _PSI_X), f2_mul(f2_conj(y), _PSI_Y), f2_conj(z))


def g2_mul_x(p):
    """[x]p for the (negative) curve parameter x."""
    return jac_neg(FP2, jac_mul(FP2, p, X_ABS))


def g2_in_subgroup(p) -> bool:
    """Scott's test: a point of E'(Fp2) lies in G2 iff ψ(p) = [x]p."""
    return jac_eq(FP2, g2_psi(p), g2_mul_x(p))


def g2_clear_cofactor(p):
    """[h_eff]p as RFC 9380 Appendix G.3 computes it."""
    t1 = g2_mul_x(p)
    t2 = g2_psi(p)
    t3 = g2_psi(g2_psi(jac_dbl(FP2, p)))
    t3 = jac_add(FP2, t3, jac_neg(FP2, t2))
    t2 = g2_mul_x(jac_add(FP2, t1, t2))
    t3 = jac_add(FP2, t3, t2)
    t3 = jac_add(FP2, t3, jac_neg(FP2, t1))
    return jac_add(FP2, t3, jac_neg(FP2, p))


# ---------------------------------------------------------------- encodings

B2 = (4, 4)


def g1_decompress(data: bytes):
    """(x, y) of a compressed G1 point, or None when it does not decode to
    a point other than infinity."""
    if len(data) != 48 or not data[0] & 0x80 or data[0] & 0x40:
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        return None
    y = fp_sqrt((x * x * x + 4) % P)
    if y is None:
        return None
    if (y > HALF_P) != bool(data[0] & 0x20):
        y = P - y
    return (x, y)


def g2_decompress(data: bytes):
    """(x, y) of a compressed G2 point; "inf" for the infinity encoding;
    None when it does not decode."""
    if len(data) != 96 or not data[0] & 0x80:
        return None
    if data[0] & 0x40:
        return "inf" if data[0] & 0x3F == 0 and not any(data[1:]) else None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        return None
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), B2))
    if y is None:
        return None
    larger = y[1] > HALF_P if y[1] else y[0] > HALF_P
    if larger != bool(data[0] & 0x20):
        y = f2_neg(y)
    return (x, y)


def g1_compress(pt) -> bytes:
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y > HALF_P else 0)
    return bytes(out)


def g2_compress(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    larger = y1 > HALF_P if y1 else y0 > HALF_P
    out[0] |= 0x80 | (0x20 if larger else 0)
    return bytes(out)


# ---------------------------------------------------------------- hash to G2

_A_ISO = (0, 240)
_B_ISO = (1012, 1012)
_Z = (P - 2, P - 1)  # −(2 + i)
# The kernel of the 3-isogeny E2' → E2 has x-coordinate −6 + 6i; Vélu's
# formulas give the isogeny onto y² = x³ + 3⁶·4(1+i), and the scaling
# (x, y) → (x/λ², y/λ³) with λ = −3 lands on E2 as RFC 9380's map does.
_X0 = (P - 6, 6)
_T = f2_scale(f2_add(f2_scale(f2_sqr(_X0), 3), _A_ISO), 2)
_U = f2_scale(f2_add(f2_add(f2_mul(f2_sqr(_X0), _X0), f2_mul(_A_ISO, _X0)), _B_ISO), 4)
_IL2 = pow(9, -1, P)
_IL3 = pow(-27 % P, -1, P)


def expand_message_xmd(msg: bytes, dst: bytes, n: int) -> bytes:
    ell = (n + 31) // 32
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(b"\x00" * 64 + msg + n.to_bytes(2, "big") + b"\x00" + dst_prime).digest()
    out = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        mixed = bytes(a ^ b for a, b in zip(b0, out[-1]))
        out.append(hashlib.sha256(mixed + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:n]


def _sswu(u):
    """Simplified SWU onto E2': y² = x³ + A'x + B'."""
    zu2 = f2_mul(_Z, f2_sqr(u))
    den = f2_add(f2_sqr(zu2), zu2)
    if den == ZERO2:
        x1 = f2_mul(_B_ISO, f2_inv(f2_mul(_Z, _A_ISO)))
    else:
        x1 = f2_mul(f2_neg(f2_mul(_B_ISO, f2_inv(_A_ISO))), f2_add(ONE2, f2_inv(den)))

    def g(x):
        return f2_add(f2_add(f2_mul(f2_sqr(x), x), f2_mul(_A_ISO, x)), _B_ISO)

    x, y = x1, f2_sqrt(g(x1))
    if y is None:
        x = f2_mul(zu2, x1)
        y = f2_sqrt(g(x))
    if f2_sgn0(u) != f2_sgn0(y):
        y = f2_neg(y)
    return x, y


def _iso(x, y):
    d = f2_inv(f2_sub(x, _X0))
    d2 = f2_sqr(d)
    d3 = f2_mul(d2, d)
    xx = f2_add(f2_add(x, f2_mul(_T, d)), f2_mul(_U, d2))
    dx = f2_sub(f2_sub(ONE2, f2_mul(_T, d2)), f2_mul(f2_add(_U, _U), d3))
    return f2_scale(xx, _IL2), f2_scale(f2_mul(y, dx), _IL3)


def hash_to_g2(msg: bytes, dst: bytes = DST):
    """H(msg) as an affine point of G2."""
    uniform = expand_message_xmd(msg, dst, 256)
    us = [(int.from_bytes(uniform[128 * i: 128 * i + 64], "big") % P,
           int.from_bytes(uniform[128 * i + 64: 128 * i + 128], "big") % P) for i in range(2)]
    q0 = _iso(*_sswu(us[0]))
    q1 = _iso(*_sswu(us[1]))
    q = jac_add(FP2, (q0[0], q0[1], ONE2), (q1[0], q1[1], ONE2))
    return jac_affine(FP2, g2_clear_cofactor(q))


# ---------------------------------------------------------------- pairing

_LOOP = bin(X_ABS)[3:]  # the bits below the top one


def miller_product(pairs):
    """Π f_{|x|,Q}(P) over (P, Q) pairs, P affine in E(Fp), Q affine in
    E'(Fp2). Lines on E' through T are untwisted and scaled by w³ (which
    the final exponentiation removes): (λx_T − y_T) − λx_P·v + y_P·v·w."""
    f = ONE12
    ts = [q for _, q in pairs]
    for bit in _LOOP:
        f = f12_sqr(f)
        for k, ((xp, yp), q) in enumerate(pairs):
            xt, yt = ts[k]
            lam = f2_mul(f2_scale(f2_sqr(xt), 3), f2_inv(f2_add(yt, yt)))
            f = f12_mul_line(f, f2_sub(f2_mul(lam, xt), yt), f2_neg(f2_scale(lam, xp)), yp)
            x3 = f2_sub(f2_sqr(lam), f2_add(xt, xt))
            yt = f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt)
            xt = x3
            if bit == "1":
                xq, yq = q
                lam = f2_mul(f2_sub(yq, yt), f2_inv(f2_sub(xq, xt)))
                f = f12_mul_line(f, f2_sub(f2_mul(lam, xt), yt), f2_neg(f2_scale(lam, xp)), yp)
                x3 = f2_sub(f2_sub(f2_sqr(lam), xt), xq)
                yt = f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt)
                xt = x3
            ts[k] = (xt, yt)
    return f


NEG_G1 = (G1[0], P - G1[1])


# ---------------------------------------------------------------- verdicts


def set_term(job):
    """(root, [r]pk, [r]sig) in Jacobian form of one set (pk bytes, root,
    sig bytes, r), or None when the set cannot verify (a key or signature
    that does not decode, a key at infinity, a signature outside G2)."""
    pk_b, root, sig_b, r = job
    pk = g1_decompress(pk_b)
    sig = g2_decompress(sig_b)
    if pk is None or sig is None:
        return None
    if sig == "inf":
        rsig = (ONE2, ONE2, ZERO2)
    else:
        sj = (sig[0], sig[1], ONE2)
        if not g2_in_subgroup(sj):
            return None
        rsig = jac_mul(FP2, sj, r)
    return (root, jac_mul(FP, (pk[0], pk[1], 1), r), rsig)


class Reference:
    """Verdicts of signature sets given as (pk bytes, 32 B root, sig bytes).
    Each set's coefficient is drawn once from `rng` (a `random.Random`),
    and each set's terms and each root's H(root) are computed once. With
    `pool` (a `multiprocessing` pool) the terms, the hashes and the Miller
    loops are spread over its workers."""

    def __init__(self, rng, pool=None):
        self._rng = rng
        self._pool = pool
        self._h2c: dict = {}
        self._terms: dict = {}

    def _map(self, fn, items):
        if self._pool is None or len(items) < 2:
            return [fn(x) for x in items]
        return self._pool.map(fn, items, chunksize=max(1, len(items) // 64))

    def _prepare(self, sets) -> None:
        fresh = list(dict.fromkeys(tuple(s) for s in sets if tuple(s) not in self._terms))
        jobs = [(pk, root, sig, self._rng.getrandbits(64) | 1) for pk, root, sig in fresh]
        for key, term in zip(fresh, self._map(set_term, jobs)):
            self._terms[key] = term
        roots = list(dict.fromkeys(t[0] for t in (self._terms[tuple(s)] for s in sets)
                                   if t is not None and t[0] not in self._h2c))
        for root, pt in zip(roots, self._map(hash_to_g2, roots)):
            self._h2c[root] = pt

    def sets_pass(self, sets) -> bool:
        """True when the random linear combination of `sets` verifies."""
        self._prepare(sets)
        by_root: dict = {}
        sig_acc = (ONE2, ONE2, ZERO2)
        for s in sets:
            term = self._terms[tuple(s)]
            if term is None:
                return False
            root, rpk, rsig = term
            by_root[root] = jac_add(FP, by_root.get(root, (1, 1, 0)), rpk)
            sig_acc = jac_add(FP2, sig_acc, rsig)
        pairs = []
        for root, acc in by_root.items():
            pt = jac_affine(FP, acc)
            if pt is not None:
                pairs.append((pt, self._h2c[root]))
        sig_pt = jac_affine(FP2, sig_acc)
        if sig_pt is not None:
            pairs.append((NEG_G1, sig_pt))
        if not pairs:
            return True
        workers = getattr(self._pool, "_processes", 1) if self._pool is not None else 1
        chunks = [pairs[i::workers] for i in range(min(workers, len(pairs)))]
        f = ONE12
        for part in self._map(miller_product, chunks):
            f = f12_mul(f, part)
        return final_exp_is_one(f)

    def each_passes(self, calls, seed: int) -> list[bool]:
        """`sets_pass` of each call on its own; calls of a few sets are spread
        whole over the pool, each with its own generator from `seed`."""
        small = [i for i, c in enumerate(calls) if len(c) <= 8]
        out = [None] * len(calls)
        jobs = [(tuple(tuple(s) for s in calls[i]), f"{seed}:{i}") for i in small]
        for i, v in zip(small, self._map(_call_passes, jobs)):
            out[i] = v
        for i, c in enumerate(calls):
            if out[i] is None:
                out[i] = self.sets_pass(c)
        return out

    def verify_calls(self, calls) -> list[bool]:
        """One verdict per call (a list of sets): True when every set of the
        call verifies. Groups of calls are checked together and halved on
        failure."""
        out = [False] * len(calls)

        def check(idx):
            if self.sets_pass([s for i in idx for s in calls[i]]):
                for i in idx:
                    out[i] = True
            elif len(idx) > 1:
                mid = len(idx) // 2
                check(idx[:mid])
                check(idx[mid:])

        if calls:
            check(list(range(len(calls))))
        return out


def _call_passes(job) -> bool:
    import random

    sets, seed = job
    return Reference(random.Random(seed)).sets_pass(sets)
