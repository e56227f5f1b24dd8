"""Generate `csrc/miller_sched.cuh`, the phase tables of K2p's warp schedule.

    python3 -m lodestar_tpu_torch.gen_miller_sched > lodestar_tpu_torch/csrc/miller_sched.cuh

K2p (`csrc/miller_warp.cuh`) runs one lane of the projective Miller loop
on one warp over a buffer of Fp slots, as K3-fe does (`tower_warp.cuh`).
Its set-up and its steps are fixed sequences of phases, written here as
data that one small interpreter runs, so that the code of each phase kind
exists once. A step's line takes two levels of products, and the first
(over T, Q and the lane's constants only) runs in the previous step's last
round, so there are three step templates: a doubling followed by a
doubling, a doubling followed by an addition, an addition. The phases:

- a MUL phase: thread t < n computes S[o] = x·y, one FIOS multiply, where
  x and y are each a sum of slots minus a sum of slots;
- a LIN phase: thread t < n computes S[o] = m·(a sum of slots minus a
  sum of slots) for a small integer m.

The formulas are written below over lazy linear combinations of slots
(`Lin`): a Karatsuba Fp2 product is three Fp products whose recombination
(x0 y0 − x1 y1, (x0 + x1)(y0 + y1) − x0 y0 − x1 y1) is not computed but
folded into whatever reads it, so most recombinations cost no phase. This
script checks every phase (at most 32 items, no slot both read and
written, every slot written before it is read), gives the temporaries
physical slots by liveness, and writes the tables.

The line and point formulas are those of `_line_and_double` with zp and
`_line_and_add_projq` (JAX `lodestar_tpu/ops/pairing.py:56`, `:102`;
`tower.cuh` `line_double_proj`, `line_add_projq`) regrouped so that each
takes two levels of products: every l0, l1, l2 and T is the same field
element as the plain loop's. `tests/test_torch_miller_warp.py` holds the
committed header equal to this script's output.
"""

from __future__ import annotations

from math import gcd

THREADS = 32
REC_BYTES = 32
REC_HEAD = 8  # out, m, four term counts, two spare
REC_TERMS = REC_BYTES - REC_HEAD

# Persistent slots. 0..21 are written by the load phase of the kernel
# itself (slot t by thread t): P, Q, zero, then f = 1.
S_P = 0  # xp, yp, zp
S_Q = 3  # Xq (2), Yq (2), Zq (2)
S_ZERO = 9
S_F = 10  # f: 12 slots, index h*6 + j*2 + c as the (2, 3, 2) limb layout
S_T = 22  # T: X, Y, Z (2 each)
S_PC = 28  # -3 xp, 2 yp, 3 zp, -2 zp
S_QC = 32  # Xq zp, Yq zp, Zq (-xp), Zq yp (2 each)
S_ST = 40  # a + b and a + v b of f = a + b w (3 Fp2 each)
S_H = 52  # the next step's level-A products and multiples
N_PERSISTENT = 81


class Lin:
    """An integer linear combination of slots."""

    __slots__ = ("t",)

    def __init__(self, terms=()):
        self.t = {k: v for k, v in dict(terms).items() if v}

    def __add__(self, o: Lin) -> Lin:
        d = dict(self.t)
        for k, v in o.t.items():
            d[k] = d.get(k, 0) + v
        return Lin(d)

    def __neg__(self) -> Lin:
        return Lin({k: -v for k, v in self.t.items()})

    def __sub__(self, o: Lin) -> Lin:
        return self + (-o)

    def __rmul__(self, c: int) -> Lin:
        return Lin({k: c * v for k, v in self.t.items()})


def s(k: int) -> Lin:
    return Lin({k: 1})


ZERO = Lin()


# Fp2 values are pairs of Lin; Fp6 values triples of Fp2 (Fp2 = Fp[u]/(u^2 + 1),
# Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + u, Fp12 = Fp6[w]/(w^2 - v), as tower.cuh)

def fp2(k: int):
    return (s(k), s(k + 1))


def add2(a, b):
    return (a[0] + b[0], a[1] + b[1])


def sub2(a, b):
    return (a[0] - b[0], a[1] - b[1])


def times2(c: int, a):
    return (c * a[0], c * a[1])


def xi(a):
    return (a[0] - a[1], a[0] + a[1])


def fp2_mul(x, y):
    """Karatsuba: (three Fp product requests, their recombination)."""
    req = [(x[0], y[0]), (x[1], y[1]), (x[0] + x[1], y[0] + y[1])]
    return req, lambda p: (p[0] - p[1], p[2] - p[0] - p[1])


def fp2_mul_fp(x, k):
    return [(x[0], k), (x[1], k)], lambda p: (p[0], p[1])


def fp6_mul(x, y):
    """Karatsuba over v (m0 = x0 y0, m1 = x1 y1, m2 = x2 y2,
    m3 = (x1 + x2)(y1 + y2), m4 = (x0 + x1)(y0 + y1), m5 = (x0 + x2)(y0 + y2))
    of Karatsuba Fp2 products: 18 requests."""
    pairs = [(x[0], y[0]), (x[1], y[1]), (x[2], y[2]), (add2(x[1], x[2]), add2(y[1], y[2])),
             (add2(x[0], x[1]), add2(y[0], y[1])), (add2(x[0], x[2]), add2(y[0], y[2]))]
    return _many([fp2_mul(a, b) for a, b in pairs], lambda m: [
        add2(m[0], xi(sub2(sub2(m[3], m[1]), m[2]))),
        add2(sub2(sub2(m[4], m[0]), m[1]), xi(m[2])),
        add2(sub2(sub2(m[5], m[0]), m[2]), m[1]),
    ])


def fp6_mul_by_01(a, b0, b1):
    """a (b0 + b1 v): 5 Fp2 products, 15 requests."""
    parts = [fp2_mul(a[0], b0), fp2_mul(a[1], b1), fp2_mul(add2(a[1], a[2]), b1),
             fp2_mul(add2(a[0], a[1]), add2(b0, b1)), fp2_mul(add2(a[0], a[2]), b0)]
    return _many(parts, lambda m: [
        add2(xi(sub2(m[2], m[1])), m[0]),
        sub2(sub2(m[3], m[0]), m[1]),
        add2(sub2(m[4], m[0]), m[1]),
    ])


def fp6_mul_by_1(a, b1):
    """a (b1 v) = (xi a2 b1, a0 b1, a1 b1): 3 Fp2 products."""
    return _many([fp2_mul(a[2], b1), fp2_mul(a[0], b1), fp2_mul(a[1], b1)],
                 lambda m: [xi(m[0]), m[1], m[2]])


def _many(parts, combine):
    """Concatenate the requests of several products; their results, each
    recombined, go to `combine` in order."""
    req = [r for part, _ in parts for r in part]

    def finish(p):
        out, i = [], 0
        for part, fin in parts:
            out.append(fin(p[i:i + len(part)]))
            i += len(part)
        return combine(out)

    return req, finish


# ---------------------------------------------------------------- templates


class Template:
    """One step's phases over virtual slots: persistent slots are their own
    numbers, temporaries count from 1000."""

    def __init__(self, name: str):
        self.name = name
        self.phases: list[tuple[str, list]] = []
        self.next_tmp = 1000

    def _tmp(self) -> int:
        self.next_tmp += 1
        return self.next_tmp - 1

    def mul(self, reqs, outs=None) -> list[Lin]:
        """A MUL phase of the requests (x, y); products to `outs` or to
        new temporaries."""
        items, res = [], []
        for i, (x, y) in enumerate(reqs):
            o = outs[i] if outs is not None and outs[i] is not None else self._tmp()
            items.append((o, x, y))
            res.append(s(o))
        self.phases.append(("mul", items))
        return res

    def lin(self, stores=(), news=()) -> list[Lin]:
        """A LIN phase: `stores` (slot, value) pairs, and `news` values
        materialised in new temporaries (returned)."""
        items = [(o, v, None) for o, v in stores]
        res = []
        for v in news:
            o = self._tmp()
            items.append((o, v, None))
            res.append(s(o))
        self.phases.append(("lin", items))
        return res

    def lin2(self, stores=(), news=()):
        """`lin` over Fp2 values: stores (slot of c0, Fp2), news Fp2."""
        flat = [(o + c, v[c]) for o, v in stores for c in (0, 1)]
        out = self.lin(flat, [v[c] for v in news for c in (0, 1)])
        return [(out[2 * i], out[2 * i + 1]) for i in range(len(news))]


def _f():
    a = [fp2(S_F + 2 * j) for j in range(3)]
    b = [fp2(S_F + 6 + 2 * j) for j in range(3)]
    return a, b


def _t():
    return fp2(S_T), fp2(S_T + 2), fp2(S_T + 4)


# Level A of each step's line (products over T, Q and the lane's constants
# only) runs in the previous step's last round, beside the line product, and
# hands its products and the multiples made from them over in the slots
# from S_H on: `*_level_a` gives the requests and their recombination,
# `*_level_a_lin` what the LIN phase after it materialises.

def dbl_level_a():
    """X^2, Y^2, Z^2, YZ, XY, X (3zp), Z (-2zp), Z (-3xp), Z (2yp): 23."""
    x, y, z = _t()
    m3xp, y2p, z3p, zm2p = (s(S_PC + k) for k in range(4))
    return _many([fp2_mul(x, x), fp2_mul(y, y), fp2_mul(z, z), fp2_mul(y, z), fp2_mul(x, y),
                  fp2_mul_fp(x, z3p), fp2_mul_fp(z, zm2p), fp2_mul_fp(z, m3xp),
                  fp2_mul_fp(z, y2p)], lambda m: m)


def dbl_level_a_lin(v):
    """t2b = b3 Z^2 = 12 xi Z^2, 8 Y^2 and Y^2."""
    zz, yy = v[2], v[1]
    return [times2(12, xi(zz)), times2(8, yy), yy]


def add_level_a():
    """X Xq, Y Yq, Z Zq, (X + Y)(Xq + Yq), Y Zq, Yq Z, X Zq, Xq Z: 24."""
    x, y, z = _t()
    xq, yq, zq = fp2(S_Q), fp2(S_Q + 2), fp2(S_Q + 4)
    return _many([fp2_mul(x, xq), fp2_mul(y, yq), fp2_mul(z, zq),
                  fp2_mul(add2(x, y), add2(xq, yq)), fp2_mul(y, zq), fp2_mul(yq, z),
                  fp2_mul(x, zq), fp2_mul(xq, z)], lambda m: m)


def add_level_a_lin(v):
    """t2b = b3 Z Zq and y3 = b3 (X Zq + Xq Z)."""
    return [times2(12, xi(v[2])), times2(12, xi(add2(v[6], v[7])))]


LEVEL_A = {"doubling": (dbl_level_a, dbl_level_a_lin), "addition": (add_level_a, add_level_a_lin)}


def _handed_over(kind: str):
    """The level-A values a step finds in the slots from S_H on."""
    level_a, level_a_lin = LEVEL_A[kind]
    req, fin = level_a()
    n_lin = len(level_a_lin(fin([ZERO] * len(req))))
    return fin([s(S_H + i) for i in range(len(req))]), \
        [fp2(S_H + len(req) + 2 * k) for k in range(n_lin)]


def _line_product(tp: Template, l0, l1, l2, nxt: str):
    """f <- f (l0 + l1 w^2 + l2 w^3) = f ((l0, l1, 0) + (0, l2, 0) w), with
    A, B = f's halves: t0 = A (l0 + l1 v), t1 = B (l2 v),
    t2 = (A + B)(l0 + (l1 + l2) v); f = (t0 + v t1, t2 - t0 - t1).
    13 Fp2 products (39 Fp products) in two rounds, the second shared with
    level A of the next step (`nxt`), then two LIN phases: the t's (and
    the next step's multiples), then f and the sums the next squaring
    needs, a + b and a + v b of the new f = a + b w."""
    a, b = _f()
    r0, f0 = fp6_mul_by_01(a, l0, l1)
    r1, f1 = fp6_mul_by_1(b, l2)
    r2, f2 = fp6_mul_by_01([add2(a[j], b[j]) for j in range(3)], l0, add2(l1, l2))
    req = r0 + r1 + r2
    level_a, level_a_lin = LEVEL_A[nxt]
    ra, fa = level_a()
    p = tp.mul(req[:THREADS])
    p2 = tp.mul(req[THREADS:] + ra, [None] * (len(req) - THREADS) + [S_H + i for i in range(len(ra))])
    p += p2[:len(req) - THREADS]
    lins = level_a_lin(fa(p2[len(req) - THREADS:]))
    m = tp.lin2(stores=[(S_H + len(ra) + 2 * k, v) for k, v in enumerate(lins)],
                news=f0(p[:15]) + f1(p[15:24]) + f2(p[24:]))
    t0, t1, t2 = m[0:3], m[3:6], m[6:9]
    c0 = [add2(t0[0], xi(t1[2])), add2(t0[1], t1[0]), add2(t0[2], t1[1])]
    c1 = [sub2(sub2(t2[j], t0[j]), t1[j]) for j in range(3)]
    _store_f(tp, c0, c1)


def _store_f(tp: Template, c0, c1):
    """A LIN phase: f = c0 + c1 w, with a + b and a + v b of it."""
    sums = [add2(c0[j], c1[j]) for j in range(3)]
    sums += [add2(c0[0], xi(c1[2])), add2(c0[1], c1[0]), add2(c0[2], c1[1])]
    tp.lin2(stores=[(S_F + 2 * j, c0[j]) for j in range(3)]
            + [(S_F + 6 + 2 * j, c1[j]) for j in range(3)]
            + [(S_ST + 2 * j, sums[j]) for j in range(6)])


def setup() -> Template:
    """T = Q; the P constants; the sums of f = 1; the Q constants
    Xq zp, Yq zp, Zq (-xp), Zq yp beside the first doubling's level A."""
    tp = Template("setup")
    xp, yp, zp = s(S_P), s(S_P + 1), s(S_P + 2)
    one = s(S_F)
    tp.lin([(S_T + k, s(S_Q + k)) for k in range(6)]
           + [(S_PC, -3 * xp), (S_PC + 1, 2 * yp), (S_PC + 2, 3 * zp), (S_PC + 3, -2 * zp)]
           + [(S_ST + k, one if k % 6 == 0 else ZERO) for k in range(12)])
    xq, yq, zq = fp2(S_Q), fp2(S_Q + 2), fp2(S_Q + 4)
    req = []
    for q, k in ((xq, zp), (yq, zp), (zq, -xp), (zq, yp)):
        req += fp2_mul_fp(q, k)[0]
    ra, fa = dbl_level_a()
    p = tp.mul(req + ra, list(range(S_QC, S_QC + 8)) + [S_H + i for i in range(len(ra))])
    tp.lin2(stores=[(S_H + len(ra) + 2 * k, v)
                    for k, v in enumerate(dbl_level_a_lin(fa(p[8:])))])
    return tp


def doubling(nxt: str) -> Template:
    """f <- f^2 l, T <- 2T with the tangent at T:
    l0 = (3X^3 - 2Y^2 Z) zp = X^2 (X 3zp) + Y^2 (Z (-2zp)),
    l1 = 3X^2 Z (-xp) = X^2 (Z (-3xp)), l2 = 2YZ^2 yp = YZ (Z 2yp),
    X' = 2 t0c XY, Y' = t2b 8Y^2 + t0c (Y^2 + t2b), Z' = YZ 8Y^2 with
    t2b = b3 Z^2 = 12 xi Z^2, t0c = Y^2 - 3 t2b; its level A came with the
    step before. f^2 by the complex squaring
    (a + b w)^2 = ((a + b)(a + v b) - ab - v ab) + 2ab w: 36 products, the
    last 4 beside the line's 24. 4 rounds, 8 phases."""
    tp = Template(f"doubling, then {nxt}")
    a, b = _f()
    sums = [fp2(S_ST + 2 * j) for j in range(6)]
    r_ab, f_ab = fp6_mul(a, b)
    r_st, f_st = fp6_mul(sums[:3], sums[3:])
    sq = r_ab + r_st
    (xx, yy, zz, yz, xy, xzp, zzp, zxp, zyp), (t2b, z8, yy) = _handed_over("doubling")
    t0c = sub2(yy, times2(3, t2b))
    y3s = add2(yy, t2b)
    rb, fb = _many([fp2_mul(xx, xzp), fp2_mul(yy, zzp), fp2_mul(xx, zxp), fp2_mul(yz, zyp),
                    fp2_mul(t2b, z8), fp2_mul(yz, z8), fp2_mul(t0c, y3s), fp2_mul(t0c, xy)],
                   lambda m: m)
    sq_p = tp.mul(sq[:THREADS])
    p = tp.mul(sq[THREADS:] + rb)
    sq_p += p[:len(sq) - THREADS]
    l0a, l0b, l1, l2, x3, z3, y3m, xt = fb(p[len(sq) - THREADS:])
    # the squaring's Fp6 products ab and (a + b)(a + v b), with T and the line
    v = tp.lin2(stores=[(S_T, times2(2, xt)), (S_T + 2, add2(x3, y3m)), (S_T + 4, z3)],
                news=f_ab(sq_p[:18]) + f_st(sq_p[18:]) + [add2(l0a, l0b), l1, l2])
    ab, prod, line = v[0:3], v[3:6], v[6:9]
    vab = [xi(ab[2]), ab[0], ab[1]]
    c0 = [sub2(sub2(prod[j], ab[j]), vab[j]) for j in range(3)]
    tp.lin2(stores=[(S_F + 2 * j, c0[j]) for j in range(3)]
            + [(S_F + 6 + 2 * j, times2(2, ab[j])) for j in range(3)])
    _line_product(tp, *line, nxt)
    return tp


def addition() -> Template:
    """f <- f l, T <- T + Q with the chord through T and Q (RCB16
    Algorithm 7, a = 0): theta' = Y Zq - Yq Z, H' = X Zq - Xq Z,
    l0 = theta' (Xq zp) - H' (Yq zp), l1 = theta' (Zq (-xp)),
    l2 = H' (Zq yp); X' = t3 t1m - t4 y3, Y' = y3 x3 + t1m z3,
    Z' = z3 t4 + x3 t3 with t3 = (X + Y)(Xq + Yq) - X Xq - Y Yq,
    t4 = Y Zq + Yq Z, x3 = 3 X Xq, z3 = Y Yq + b3 Z Zq,
    t1m = Y Yq - b3 Z Zq, y3 = b3 (X Zq + Xq Z); its level A came with the
    step before, and a doubling always follows. 3 rounds, 6 phases."""
    tp = Template("addition")
    qxz, qyz, qzx, qzy = (fp2(S_QC + 2 * k) for k in range(4))
    (t0, t1, t2, u, yzq, yqz, xzq, xqz), (t2b, y3) = _handed_over("addition")
    theta, h = sub2(yzq, yqz), sub2(xzq, xqz)
    t3, t4, x3 = sub2(sub2(u, t0), t1), add2(yzq, yqz), times2(3, t0)
    z3, t1m = add2(t1, t2b), sub2(t1, t2b)
    rb, fb = _many([fp2_mul(t3, t1m), fp2_mul(t4, y3), fp2_mul(y3, x3), fp2_mul(t1m, z3),
                    fp2_mul(z3, t4), fp2_mul(x3, t3), fp2_mul(theta, qxz), fp2_mul(h, qyz),
                    fp2_mul(theta, qzx), fp2_mul(h, qzy)], lambda m: m)
    pa, pb, pc, pd, pe, pf, l0a, l0b, l1, l2 = fb(tp.mul(rb))
    line = tp.lin2(stores=[(S_T, sub2(pa, pb)), (S_T + 2, add2(pc, pd)), (S_T + 4, add2(pe, pf))],
                   news=[sub2(l0a, l0b), l1, l2])
    _line_product(tp, *line, "doubling")
    return tp


# ---------------------------------------------------------------- checks and tables


def _terms(v: Lin, scaled: bool):
    """(multiplier, positive slots, negative slots) of v: coefficients as
    repeated slots, their common factor as the multiplier where allowed."""
    if not v.t:
        return 1, [S_ZERO], []
    m = 1
    if scaled:
        m = 0
        for c in v.t.values():
            m = gcd(m, abs(c))
    pos = [k for k, c in sorted(v.t.items()) if c > 0 for _ in range(c // m)]
    neg = [k for k, c in sorted(v.t.items()) if c < 0 for _ in range(-c // m)]
    if not pos:
        pos = [S_ZERO]
    return m, pos, neg


def allocate(tp: Template, first: int) -> tuple[dict[int, int], int]:
    """Physical slots for the temporaries by liveness: a slot whose value
    was last read in phase k is free again from phase k + 1. Returns the
    map and the number of slots used."""
    defined, last = {}, {}
    for k, (_, items) in enumerate(tp.phases):
        for o, x, y in items:
            for v in (x, y):
                if v is None:
                    continue
                for slot in v.t:
                    if slot >= 1000:
                        if defined.get(slot, k) >= k:
                            raise ValueError(f"{tp.name}: phase {k} reads {slot} before it is written")
                    last[slot] = k
            if o >= 1000:
                if o in defined:
                    raise ValueError(f"{tp.name}: temporary {o} written twice")
                defined[o] = k
    for o in defined:
        if o not in last:
            raise ValueError(f"{tp.name}: temporary {o} (phase {defined[o]}) is never read")
    phys, free, live, top = {}, [], {}, first
    for k in range(len(tp.phases)):
        for o in [o for o, kk in live.items() if last[o] < k]:
            free.append(live.pop(o))
        free.sort()
        for o in sorted(o for o, d in defined.items() if d == k):
            if free:
                phys[o] = free.pop(0)
            else:
                phys[o] = top
                top += 1
            live[o] = phys[o]
    return phys, top


def check_phase(name: str, k: int, kind: str, items) -> None:
    writes = [o for o, _, _ in items]
    if len(set(writes)) != len(writes):
        raise ValueError(f"{name}: phase {k} writes a slot twice")
    reads = {slot for _, x, y in items for v in (x, y) if v is not None for slot in v.t}
    if reads & set(writes):
        raise ValueError(f"{name}: phase {k} reads a slot it writes")
    if len(items) > THREADS:
        raise ValueError(f"{name}: phase {k} has {len(items)} items for {THREADS} threads")


def records(templates: list[Template]):
    """(record bytes, phase words, template starts, slots used, per-phase
    (template, kind, items))."""
    recs, phases, starts, info = [], [], [], []
    slots = N_PERSISTENT
    for tp in templates:
        phys, used = allocate(tp, N_PERSISTENT)
        slots = max(slots, used)
        starts.append(len(phases))

        def p(v: Lin) -> Lin:
            return Lin({phys.get(k, k): c for k, c in v.t.items()})

        for k, (kind, items) in enumerate(tp.phases):
            items = [(phys.get(o, o), p(x), None if y is None else p(y)) for o, x, y in items]
            check_phase(tp.name, k, kind, items)
            phases.append((0 if kind == "lin" else 1) | len(items) << 1 | (len(recs) // REC_BYTES) << 8)
            for o, x, y in items:
                if kind == "mul":
                    (_, xp, xn), (_, yp, yn) = _terms(x, False), _terms(y, False)
                    m = 1
                else:
                    m, xp, xn = _terms(x, True)
                    yp, yn = [], []
                slots_ = xp + xn + yp + yn
                if len(slots_) > REC_TERMS or m > 255:
                    raise ValueError(f"{tp.name}: phase {k}: {len(slots_)} terms, multiplier {m}")
                head = [o, m, len(xp), len(xn), len(yp), len(yn), 0, 0]
                recs += head + slots_ + [0] * (REC_TERMS - len(slots_))
            info.append((tp.name, kind, len(items)))
    starts.append(len(phases))
    if slots > 255:
        raise ValueError(f"{slots} slots do not fit a byte")
    return recs, phases, starts, slots, info


TEMPLATES = ("setup", "doubling, then doubling", "doubling, then addition", "addition")


def schedule():
    return records([setup(), doubling("doubling"), doubling("addition"), addition()])


X_ABS = 0xD201000000010000


def steps() -> list[str]:
    """The templates one lane runs, in order: the set-up, then per bit of
    |x| after the leading one a doubling (followed by the template that
    knows what comes next) and on a set bit an addition."""
    bits = bin(X_ABS)[3:]
    out = ["setup"]
    for bit in bits:
        out.append("doubling, then addition" if bit == "1" else "doubling, then doubling")
        if bit == "1":
            out.append("addition")
    return out


def counts() -> dict[str, int]:
    """Rounds, phases and Fp multiplies of one lane (the kernel's load
    and output phases included), and per template."""
    _, _, _, slots, info = schedule()
    per = {}
    for name in TEMPLATES:
        ph = [i for i in info if i[0] == name]
        per[name] = (sum(1 for i in ph if i[1] == "mul"), len(ph),
                     sum(i[2] for i in ph if i[1] == "mul"))
    run = steps()
    return {"rounds": sum(per[t][0] for t in run), "phases": 2 + sum(per[t][1] for t in run),
            "fp_muls": sum(per[t][2] for t in run), "slots": slots,
            "doubling_rounds": per[TEMPLATES[1]][0], "doubling_phases": per[TEMPLATES[1]][1],
            "addition_rounds": per[TEMPLATES[3]][0], "addition_phases": per[TEMPLATES[3]][1]}


def _rows(values, per_line: int, fmt: str) -> str:
    lines = []
    for i in range(0, len(values), per_line):
        lines.append("    " + ", ".join(fmt.format(v) for v in values[i:i + per_line]) + ", \\")
    return "\n".join(lines)


def render() -> str:
    recs, phases, starts, slots, _ = schedule()
    c = counts()
    return "\n".join([
        "// K2p's warp schedule: the phase tables that miller_warp.cuh runs.",
        "// Generated by `python3 -m lodestar_tpu_torch.gen_miller_sched`; do not edit.",
        f"// Per lane: {c['rounds']} rounds, {c['phases']} phases, {c['fp_muls']} Fp multiplies;",
        f"// a doubling step {c['doubling_rounds']} rounds in {c['doubling_phases']} phases, an "
        f"addition step {c['addition_rounds']} in {c['addition_phases']}.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace tww {",
        "namespace ml {",
        "",
        f"constexpr int kP = {S_P};  // xp, yp, zp as loaded",
        f"constexpr int kQ = {S_Q};  // Xq, Yq, Zq as loaded",
        f"constexpr int kZero = {S_ZERO};",
        f"constexpr int kF = {S_F};  // f, the (2, 3, 2) layout",
        f"constexpr int kLoaded = {S_F + 12};  // slots 0 .. kLoaded - 1: the load phase",
        f"constexpr int kSlots = {slots};",
        f"constexpr int kSlotWords = kSlots * 12;  // {slots * 48:,} B per lane",
        f"constexpr int kRecBytes = {REC_BYTES};  // out, m, term counts (x+, x-, y+, y-), 2 spare, slots",
        "// phase ranges: the set-up; a doubling followed by a doubling; a doubling",
        "// followed by an addition; an addition (a doubling follows)",
        f"constexpr int kSetup = {starts[0]}, kDoubling = {starts[1]}, "
        f"kDoublingThenAddition = {starts[2]},",
        f"              kAddition = {starts[3]}, kEnd = {starts[4]};",
        "",
        "}  // namespace ml",
        "}  // namespace tww",
        "",
        "// per phase: bit 0 MUL (1) or LIN (0), bits 1-7 the item count, bits 8- the first record",
        "#define TWW_ML_PHASES { \\",
        _rows(phases, 8, "0x{:08x}u"),
        "  }",
        "",
        f"// {len(recs) // REC_BYTES} records of {REC_BYTES} bytes",
        "#define TWW_ML_RECORDS { \\",
        _rows(recs, 16, "{:3d}"),
        "  }",
        "",
    ])


if __name__ == "__main__":
    print(render(), end="")
