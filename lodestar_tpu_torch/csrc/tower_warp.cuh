// The final exponentiation with one warp per lane (K3-fe), shared by the
// CUDA kernel (tower.cu) and the host harness (tower_host.cpp), which
// emulates the warp. Its Fp operations, slots and `Warp` phase runner also carry
// K2p's Miller loop (miller_warp.cuh).
//
// The lane's Fp12 values live in a buffer of Fp slots (12 words each,
// fully reduced Montgomery form, as in tower.cuh) that the warp shares:
// shared memory on the card, an array on the host. Every tower operation
// is a fixed sequence of PHASES. In a phase, thread t (0..31) does at most
// one Fp multiply (FIOS Montgomery, in registers) or a few additions,
// reads only slots that no thread writes in the same phase, and writes
// only its own slots; phases are separated by __syncwarp(). The `Warp`
// template argument runs them: `w.phase(f)` runs f(tid) on every thread
// and then synchronises the warp. The host harness runs f for tid 0..31 in
// turn, or 31..0; the two orders agree limb for limb only if no thread of
// a phase reads what another one writes in it.
//
// How the work spreads (a round is a phase with multiplies; 398 rounds
// and 918 phases per lane, counted by the host harness):
// - Fp12 product: Karatsuba over w, over v and over u: the w-level operand
//   sums in one phase, 54 Fp products in two phases of at most 32, then
//   four addition phases (Fp2, the two halves of Fp6, Fp12);
// - Granger-Scott cyclotomic squaring: 27 signed Fp products in one phase,
//   then one addition phase;
// - Frobenius: 6 Fp2 products by gamma = 18 Fp products, one phase;
// - the easy part's Fp12 -> Fp6 -> Fp2 inversion: a few phases per level,
//   and the one Fp inversion on thread 0 by a variable-time binary extended
//   Euclid (every input of a verdict is public) while the others wait at
//   the next __syncwarp();
// - the exponent loops over the bits of |x| are control flow that the whole
//   warp follows: a small program of Fp12 operations (`program`) run by one
//   loop, so each operation's code exists once and nothing is a call.
//
// Defining TOWER_COUNT_MULS (the host harness does) counts Fp multiplies in
// `tw_fp_muls`, as for the one-thread tower.
#pragma once

#include <stdint.h>

#include "tower.cuh"

#ifdef __CUDACC__
#define TWW_INL __host__ __device__ __forceinline__
#else
#define TWW_INL inline
#endif

namespace tww {

using tw::Fp;
constexpr int kW = fpm::kWords;

// Slots, in Fp units: five Fp12 values, the products of a phase (54 at
// most) and the Fp2 results built from them (36 at most).
constexpr int kF = 0, kA = 12, kB = 24, kC = 36, kT = 48;
constexpr int kP = 60;
constexpr int kQ = kP + 54;
constexpr int kSlots = kQ + 36;
constexpr int kSlotWords = kSlots * kW;  // 1,800 words: 7,200 B per lane

// Operation codes of the program
enum : uint32_t { kOpEnd, kOpMul, kOpConj, kOpFrob, kOpPow, kOpCopy, kOpCyc };

#ifdef __CUDACC__
__device__ const uint32_t kGammaDevice[3 * 6 * 2 * kW] = TW_GAMMA_WORDS;
#endif
static const uint32_t kGammaHost[3 * 6 * 2 * kW] = TW_GAMMA_WORDS;

// ---------------------------------------------------------------- Fp in registers

TWW_INL void ld(Fp& x, const uint32_t* S, int k) {
#ifdef __CUDA_ARCH__
  const uint4* s = reinterpret_cast<const uint4*>(S + kW * k);
#pragma unroll
  for (int i = 0; i < 3; i++) {
    const uint4 v = s[i];
    x.w[4 * i] = v.x;
    x.w[4 * i + 1] = v.y;
    x.w[4 * i + 2] = v.z;
    x.w[4 * i + 3] = v.w;
  }
#else
  for (int i = 0; i < kW; i++) x.w[i] = S[kW * k + i];
#endif
}

TWW_INL void st(uint32_t* S, int k, const Fp& x) {
#ifdef __CUDA_ARCH__
  uint4* s = reinterpret_cast<uint4*>(S + kW * k);
#pragma unroll
  for (int i = 0; i < 3; i++)
    s[i] = make_uint4(x.w[4 * i], x.w[4 * i + 1], x.w[4 * i + 2], x.w[4 * i + 3]);
#else
  for (int i = 0; i < kW; i++) S[kW * k + i] = x.w[i];
#endif
}

// the words of gamma_i^(k) from word `off` of the table
TWW_INL void ld_gamma(Fp& x, int off) {
#pragma unroll
  for (int i = 0; i < kW; i++) {
#ifdef __CUDA_ARCH__
    x.w[i] = kGammaDevice[off + i];
#else
    x.w[i] = kGammaHost[off + i];
#endif
  }
}

// r = s - p if s >= p, else s (s < 2^384)
TWW_INL void reduce(Fp& r, const uint32_t s[kW]) {
  uint32_t p[kW], t[kW];
  fpm::load_p(p);
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    const uint64_t d = (uint64_t)s[i] - p[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
#pragma unroll
  for (int i = 0; i < kW; i++) r.w[i] = borrow ? s[i] : t[i];
}

TWW_INL void add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[kW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce(r, s);  // a + b < 2p < 2^382: no carry out
}

TWW_INL void sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t p[kW], t[kW];
  fpm::load_p(p);
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    const uint64_t d = (uint64_t)a.w[i] - b.w[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // a < b: add p back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    c += (uint64_t)t[i] + (p[i] & mask);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

TWW_INL void neg(Fp& r, const Fp& a) {
  Fp z;
#pragma unroll
  for (int i = 0; i < kW; i++) z.w[i] = 0;
  sub(r, z, a);
}

// r = c ? a : b, word by word (a select of whole structs can go through
// local memory)
TWW_INL void sel(Fp& r, bool c, const Fp& a, const Fp& b) {
#pragma unroll
  for (int i = 0; i < kW; i++) r.w[i] = c ? a.w[i] : b.w[i];
}

// r = a b R^-1 mod p for a, b < p. FIOS: the row a b_i and its reduction
// m p run in one pass over the words, on two carry chains side by side,
// where fp_mont.cuh's CIOS makes two passes. m is the same, so the sum is
// the same integer, < 2p before the final subtraction.
TWW_INL void mul(Fp& r, const Fp& a, const Fp& b) {
  TW_COUNT_MUL();
  uint32_t p[kW], t[kW + 1];
  fpm::load_p(p);
#pragma unroll
  for (int j = 0; j <= kW; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    uint64_t s = (uint64_t)t[0] + (uint64_t)a.w[0] * b.w[i];
    const uint32_t m = (uint32_t)s * fpm::kN0;
    uint64_t u = (uint64_t)(uint32_t)s + (uint64_t)m * p[0];  // low word 0
    uint64_t c = s >> 32, d = u >> 32;
#pragma unroll
    for (int j = 1; j < kW; j++) {
      s = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      c = s >> 32;
      u = (uint64_t)(uint32_t)s + (uint64_t)m * p[j] + d;
      d = u >> 32;
      t[j - 1] = (uint32_t)u;
    }
    s = (uint64_t)t[kW] + c + d;
    t[kW - 1] = (uint32_t)s;
    t[kW] = (uint32_t)(s >> 32);
  }
  reduce(r, t);  // t[kW] = 0: the sum is < 2p < 2^382
}

// component c of xi * (the Fp2 at slot `base`): c0 - c1 for c = 0, c0 + c1 for c = 1
TWW_INL void xi_c(Fp& r, const uint32_t* S, int base, int c) {
  Fp b0, b1;
  ld(b0, S, base);
  ld(b1, S, base + 1);
  if (c) {
    add(r, b0, b1);
  } else {
    sub(r, b0, b1);
  }
}

// 32 limbs of 12 bits -> a reduced element (tower.cuh's load_fp, inline)
TWW_INL void load_limbs(Fp& r, const int32_t* limbs) {
  int32_t l[fpm::kLimbs];
#pragma unroll
  for (int i = 0; i < fpm::kLimbs; i++) l[i] = limbs[i] & 0xfff;
  uint32_t s[kW];
  fpm::pack(s, l);
#pragma unroll 1
  for (int k = 0; k < 10; k++) {  // 2^384 < 10p
    reduce(r, s);
#pragma unroll
    for (int i = 0; i < kW; i++) s[i] = r.w[i];
  }
}

// ---------------------------------------------------------------- the Euclid inverse

TWW_INL int ctz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// u >>= k for 1 <= k <= 32
TWW_INL void shr(uint32_t u[kW], int k) {
#pragma unroll
  for (int i = 0; i < kW; i++) {
    const uint64_t hi = i + 1 < kW ? (uint64_t)u[i + 1] << 32 : 0;
    u[i] = (uint32_t)((hi | u[i]) >> k);
  }
}

// x <- x / 2^k mod p for x < p, 1 <= k <= 32: x + m p with
// m = -x p^-1 mod 2^k is divisible by 2^k, and (x + m p) / 2^k < p
TWW_INL void halve(uint32_t x[kW], int k) {
  uint32_t p[kW], t[kW + 1];
  fpm::load_p(p);
  const uint32_t mask = k == 32 ? 0xffffffffu : (1u << k) - 1;
  const uint32_t m = (x[0] * fpm::kN0) & mask;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    c += (uint64_t)x[i] + (uint64_t)m * p[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  t[kW] = (uint32_t)c;
#pragma unroll
  for (int i = 0; i < kW; i++) x[i] = (uint32_t)((((uint64_t)t[i + 1] << 32) | t[i]) >> k);
}

// divide u (nonzero) by its largest power of two 2^e, and x by 2^e mod p
TWW_INL void make_odd(uint32_t u[kW], uint32_t x[kW]) {
  while ((u[0] & 1) == 0) {
    const int k = u[0] == 0 ? 32 : ctz32(u[0]);
    shr(u, k);
    halve(x, k);
  }
}

// a - b for a >= b, no reduction
TWW_INL void sub_words(uint32_t r[kW], const uint32_t a[kW], const uint32_t b[kW]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    const uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
}

// a > b (0), a == b (1), a < b (2)
TWW_INL int cmp_words(const uint32_t a[kW], const uint32_t b[kW]) {
  int r = 1;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    if (a[i] != b[i]) r = a[i] > b[i] ? 0 : 2;
  }
  return r;
}

// r = a^-1 for a reduced Montgomery value aR (0 maps to 0). The binary
// extended Euclid keeps x1 a = u and x2 a = v (mod p) from u = a, v = p;
// each step subtracts the smaller of the odd u, v from the larger and
// halves the difference until it is odd again, down to u = v = 1. Then
// x1 = (aR)^-1 = a^-1 R^-1, and one Montgomery multiply by R^3 mod p gives
// a^-1 R. Variable time: the inputs of a verdict are public.
TWW_INL void fp_inv_euclid(Fp& r, const Fp& a) {
  uint32_t u[kW], v[kW];
  Fp x1, x2, r3;
  bool zero = true;
#pragma unroll
  for (int i = 0; i < kW; i++) {
    u[i] = a.w[i];
    x1.w[i] = 0;
    x2.w[i] = 0;
    zero = zero && a.w[i] == 0;
  }
  fpm::load_p(v);
  if (!zero) {
    x1.w[0] = 1;
    make_odd(u, x1.w);
    for (int c = cmp_words(u, v); c != 1; c = cmp_words(u, v)) {
      if (c == 0) {
        sub_words(u, u, v);
        sub(x1, x1, x2);
        make_odd(u, x1.w);
      } else {
        sub_words(v, v, u);
        sub(x2, x2, x1);
        make_odd(v, x2.w);
      }
    }
  }
  tw::consts::r3(r3.w);
  mul(r, x1, r3);  // zero: 0 R^3 = 0, and the multiply count stays data-independent
}

// ---------------------------------------------------------------- Fp12 operations as phases

// dst = src, or conj(src) (the w-odd half negated)
template <class Warp>
TWW_INL void copy12(Warp& w, uint32_t* S, int dst, int src, bool conj) {
  w.phase([&](int t) {
    if (t >= 12) return;
    Fp x;
    ld(x, S, src + t);
    if (conj && t >= 6) neg(x, x);
    st(S, dst + t, x);
  });
}

// The Karatsuba recombination of K <= 32 Fp2 products from P[3q],
// P[3q + 1], P[3q + 2] (x0 y0, x1 y1, (x0 + x1)(y0 + y1)):
// c0 = P0 - P1, c1 = P2 - (P0 + P1), written to the Fp2 at dst + 2q, or,
// for the Frobenius, at dst + 2 pos(q) with pos = (0, 3, 1, 4, 2, 5).
template <class Warp>
TWW_INL void fp2_recombine(Warp& w, uint32_t* S, int K, int dst, bool frob_order) {
  w.phase([&](int q) {
    if (q >= K) return;
    Fp p0, p1, p2, r;
    ld(p0, S, kP + 3 * q);
    ld(p1, S, kP + 3 * q + 1);
    ld(p2, S, kP + 3 * q + 2);
    sub(r, p0, p1);
    add(p0, p0, p1);
    sub(p2, p2, p0);
    const int qd = frob_order ? ((q & 1) ? 3 : 0) + (q >> 1) : q;
    st(S, dst + 2 * qd, r);
    st(S, dst + 2 * qd + 1, p2);
  });
}

// K <= 6 Fp2 products X_q Y_q, X_q the Fp2 at xbase + 2 xi[q] and Y_q at
// ybase + 2 yi[q] (indices packed 4 bits per q): 3K Fp products, one
// phase, then recombined into the K Fp2 at dst.
template <class Warp>
TWW_INL void fp2_products(Warp& w, uint32_t* S, int K, int xbase, uint32_t xi, int ybase,
                          uint32_t yi, int dst) {
  w.phase([&](int t) {
    if (t >= 3 * K) return;
    const int q = t / 3, l2 = t % 3;
    const int xo = xbase + 2 * (int)((xi >> (4 * q)) & 0xf);
    const int yo = ybase + 2 * (int)((yi >> (4 * q)) & 0xf);
    Fp x, y, u;
    ld(x, S, xo + (l2 == 1));
    ld(y, S, yo + (l2 == 1));
    if (l2 == 2) {
      ld(u, S, xo + 1);
      add(x, x, u);
      ld(u, S, yo + 1);
      add(y, y, u);
    }
    mul(x, x, y);
    st(S, kP + t, x);
  });
  fp2_recombine(w, S, K, dst, false);
}

// K <= 3 Fp6 products X_L Y_L, X_L the Fp6 at xa[L] and Y_L at ya[L]
// (slots packed 8 bits per L). Karatsuba over v (m0 = x0 y0, m1 = x1 y1,
// m2 = x2 y2, m3 = (x1 + x2)(y1 + y2), m4 = (x0 + x1)(y0 + y1),
// m5 = (x0 + x2)(y0 + y2)) over Karatsuba over u: 18K Fp products in two
// phases of at most 32, the operand sums formed by the thread that
// multiplies. The products end as Fp6 values V_L at kP + 18 + 6L.
template <class Warp>
TWW_INL void fp6_products(Warp& w, uint32_t* S, int K, uint32_t xa, uint32_t ya) {
#pragma unroll 1
  for (int half = 0; half < 2; half++) {
    w.phase([&](int t) {
      const int k = t + 32 * half;
      if (k >= 18 * K) return;
      const int L = k / 18, l6 = (k % 18) / 3, l2 = k % 3;
      const int x0 = (int)((xa >> (8 * L)) & 0xff), y0 = (int)((ya >> (8 * L)) & 0xff);
      // the Fp2 indices summed (s0, and s1 where l6 >= 3) and the components
      const int s0 = l6 < 3 ? l6 : (l6 == 3 ? 1 : 0);
      const int s1 = l6 == 4 ? 1 : 2;
      const int c0 = l2 == 1 ? 1 : 0;
      Fp x, y, u;
      ld(x, S, x0 + 2 * s0 + c0);
      ld(y, S, y0 + 2 * s0 + c0);
#pragma unroll
      for (int term = 1; term < 4; term++) {
        const bool tc = term & 1, ts = term & 2;
        if ((tc && l2 != 2) || (ts && l6 < 3)) continue;
        const int off = 2 * (ts ? s1 : s0) + (tc ? 1 : c0);
        ld(u, S, x0 + off);
        add(x, x, u);
        ld(u, S, y0 + off);
        add(y, y, u);
      }
      mul(x, x, y);
      st(S, kP + k, x);
    });
  }
  fp2_recombine(w, S, 6 * K, kQ, false);  // m_i of pair L at kQ + 12L + 2i
  // s0 = m3 - m1 - m2, s1 = m4 - m0 - m1, s2 = m5 - m0 - m2 + m1 at kP + 6L + 2i
  w.phase([&](int t) {
    if (t >= 6 * K) return;
    const int L = t / 6, i = (t % 6) >> 1, c = t & 1;
    const int m = kQ + 12 * L + c;
    Fp r, u;
    ld(r, S, m + 2 * (3 + i));
    ld(u, S, m + 2 * (i == 0 ? 1 : 0));
    sub(r, r, u);
    ld(u, S, m + 2 * (i == 1 ? 1 : 2));
    sub(r, r, u);
    if (i == 2) {
      ld(u, S, m + 2);
      add(r, r, u);
    }
    st(S, kP + t, r);
  });
  // V_L = (m0 + xi s0, s1 + xi m2, s2)
  w.phase([&](int t) {
    if (t >= 6 * K) return;
    const int L = t / 6, i = (t % 6) >> 1, c = t & 1;
    const int sb = kP + 6 * L, m = kQ + 12 * L;
    Fp r, u;
    if (i == 2) {
      ld(r, S, sb + 4 + c);
    } else {
      ld(r, S, i == 0 ? m + c : sb + 2 + c);
      xi_c(u, S, i == 0 ? sb : m + 4, c);
      add(r, r, u);
    }
    st(S, kP + 18 + t, r);
  });
}

// dst = a b in Fp12: V0 = a0 b0, V1 = a1 b1, V2 = (a0 + a1)(b0 + b1);
// dst = (V0 + v V1, V2 - V0 - V1) with v (x0, x1, x2) = (xi x2, x0, x1).
// dst may be a or b.
template <class Warp>
TWW_INL void fp12_mul(Warp& w, uint32_t* S, int dst, int a, int b) {
  // a0 + a1 and b0 + b1 at kQ, kQ + 6 (free until the products' recombination)
  w.phase([&](int t) {
    if (t >= 12) return;
    const int src = t < 6 ? a + t : b + t - 6;
    Fp x, y;
    ld(x, S, src);
    ld(y, S, src + 6);
    add(x, x, y);
    st(S, kQ + t, x);
  });
  fp6_products(w, S, 3, a | (a + 6) << 8 | kQ << 16, b | (b + 6) << 8 | (kQ + 6) << 16);
  w.phase([&](int t) {
    if (t >= 12) return;
    const int V = kP + 18, s = (t % 6) >> 1, c = t & 1;
    Fp r, u;
    if (t < 6) {
      ld(r, S, V + 2 * s + c);
      if (s == 0) {
        xi_c(u, S, V + 6 + 4, c);
      } else {
        ld(u, S, V + 6 + 2 * (s - 1) + c);
      }
      add(r, r, u);
    } else {
      ld(r, S, V + 12 + 2 * s + c);
      ld(u, S, V + 2 * s + c);
      sub(r, r, u);
      ld(u, S, V + 6 + 2 * s + c);
      sub(r, r, u);
    }
    st(S, dst + t, r);
  });
}

// Granger-Scott squaring, valid in the cyclotomic subgroup (and 0 -> 0),
// as tower.cuh's fp12_cyclotomic_sqr: with g = ((a, b, c), (d, e, f)),
//   T = (a^2 + xi e^2, d^2 + xi c^2, b^2 + xi f^2, xi 2bf, 2ae, 2cd),
//   dst = 3T - 2g on the first half, 3T + 2g on the second.
// Each Fp component of T is a sum of two or three of 27 Fp products X Y,
// each signed as its sum needs it, so the warp forms them in one phase
// and each output in one more:
//   x^2 + xi y^2 = ((x0 + x1)(x0 - x1) + (y0 + y1)(y0 - y1) - 2y0 y1,
//                   2x0 x1 + (y0 + y1)(y0 - y1) + 2y0 y1)
//     products 5j..5j + 4: (x0 + x1)(x0 - x1), 2x0 x1, (y0 + y1)(y0 - y1),
//     2y0 y1, -2y0 y1 for (x, y) = (a, e), (d, c), (b, f), j = 0, 1, 2;
//   xi 2bf = (2b0 (f0 - f1) - 2b1 (f0 + f1), 2b0 (f0 + f1) + 2b1 (f0 - f1))
//     products 15..18 in that order;
//   2ae = (2a0 e0 - 2a1 e1, 2a0 e1 + 2a1 e0), products 19..22, and 2cd
//     the same, products 23..26.
// So component o < 6 of T sums products 5j + c, 5j + 2 and 5j + 4 - c
// (j = o / 2, c = o % 2), and o >= 6 sums 2o + 3 and 2o + 4.
// dst may be g.
template <class Warp>
TWW_INL void cyclotomic_sqr(Warp& w, uint32_t* S, int dst, int g) {
  w.phase([&](int t) {
    if (t >= 27) return;
    // X from the Fp2 u: u0 + u1 or 2ui; Y from the Fp2 v: u0 - u1, vi, v0 + v1
    // or v0 - v1
    int u, v, xi;  // xi: X = u0 + u1 (-1), or 2u_xi
    int yi;        // Y = v_yi (0, 1), v0 + v1 (2), v0 - v1 (3)
    bool negate;
    if (t < 15) {
      const int j = t / 5, r = t % 5;
      const int x = j == 0 ? 0 : (j == 1 ? 3 : 1), y = j == 0 ? 4 : (j == 1 ? 2 : 5);
      u = v = r < 2 ? x : y;
      xi = (r & 1) == 0 && r != 4 ? -1 : 0;
      yi = xi < 0 ? 3 : 1;
      negate = r == 4;
    } else {
      const int r = (t - 15) & 3, pair = (t - 15) >> 2;  // (b, f), (a, e), (c, d)
      u = pair == 0 ? 1 : (pair == 1 ? 0 : 2);
      v = pair == 0 ? 5 : (pair == 1 ? 4 : 3);
      xi = r == 0 || r == 2 ? 0 : 1;
      const bool first = r == 0 || r == 3;  // f0 - f1 or v0 for products 0, 3
      yi = pair == 0 ? (first ? 3 : 2) : (first ? 0 : 1);
      negate = r == 1;
    }
    Fp u0, u1, v0, v1, x, y, s, d;
    ld(u0, S, g + 2 * u);
    ld(u1, S, g + 2 * u + 1);
    ld(v0, S, g + 2 * v);
    ld(v1, S, g + 2 * v + 1);
    sel(x, xi == 1, u1, u0);
    sel(y, xi == 0, u0, u1);
    add(x, x, y);
    add(s, v0, v1);
    sub(d, v0, v1);
    sel(s, yi == 2, s, d);
    sel(y, yi == 0, v0, v1);
    sel(y, yi >= 2, s, y);
    mul(x, x, y);
    neg(y, x);
    sel(x, negate, y, x);
    st(S, kP + t, x);
  });
  w.phase([&](int t) {
    if (t >= 12) return;
    const int j = t >> 1, c = t & 1;
    Fp tt, x, y;
    if (t < 6) {
      ld(tt, S, kP + 5 * j + c);
      ld(y, S, kP + 5 * j + 2);
      add(tt, tt, y);
      ld(y, S, kP + 5 * j + 4 - c);
    } else {
      ld(tt, S, kP + 2 * t + 3);
      ld(y, S, kP + 2 * t + 4);
    }
    add(tt, tt, y);
    ld(x, S, g + t);
    neg(y, x);
    sel(x, t < 6, y, x);
    add(y, tt, x);
    add(y, y, y);
    add(y, y, tt);  // 3T - 2g, or 3T + 2g
    st(S, dst + t, y);
  });
}

// dst = src^(p^k), k = 1..3: the w-coefficients (c00, c10, c01, c11, c02,
// c12), conjugated for odd k, times gamma_i^(k). dst may be src.
template <class Warp>
TWW_INL void frobenius(Warp& w, uint32_t* S, int dst, int src, int k) {
  w.phase([&](int t) {
    if (t >= 18) return;
    const int i = t / 3, l2 = t % 3;
    const int xo = src + 2 * (((i & 1) ? 3 : 0) + (i >> 1));
    const int g = ((k - 1) * 6 + i) * 2 * kW;
    Fp x, y, u;
    if (l2 == 0) {
      ld(x, S, xo);
      ld_gamma(y, g);
    } else if (l2 == 1) {
      ld(x, S, xo + 1);
      if (k & 1) neg(x, x);
      ld_gamma(y, g + kW);
    } else {
      ld(x, S, xo);
      ld(u, S, xo + 1);
      if (k & 1) {
        sub(x, x, u);
      } else {
        add(x, x, u);
      }
      ld_gamma(y, g);
      ld_gamma(u, g + kW);
      add(y, y, u);
    }
    mul(x, x, y);
    st(S, kP + t, x);
  });
  fp2_recombine(w, S, 6, dst, true);
}

// kT = kF^-1 in Fp12 (0 maps to 0), as tower.cuh's fp12_inv -> fp6_inv ->
// fp2_inv, the Fp inverse by fp_inv_euclid on thread 0. Scratch: kA, kB.
template <class Warp>
TWW_INL void fp12_inv(Warp& w, uint32_t* S) {
  constexpr int a = kF, N = kA, Cn = kA + 6, Tt = kB, Ti = kB + 3, Ni = kB + 6;
  // N = a0^2 - v a1^2
  fp6_products(w, S, 2, a | (a + 6) << 8, a | (a + 6) << 8);
  w.phase([&](int t) {
    if (t >= 6) return;
    const int V = kP + 18, s = t >> 1, c = t & 1;
    Fp r, u;
    ld(r, S, V + t);
    if (s == 0) {
      xi_c(u, S, V + 6 + 4, c);
    } else {
      ld(u, S, V + 6 + 2 * (s - 1) + c);
    }
    sub(r, r, u);
    st(S, N + t, r);
  });
  // Q = (N0^2, N1 N2, N2^2, N0 N1, N1^2, N0 N2);
  // Cn = (Q0 - xi Q1, xi Q2 - Q3, Q4 - Q5)
  fp2_products(w, S, 6, N, 0x010210u, N, 0x211220u, kQ);
  w.phase([&](int t) {
    if (t >= 6) return;
    const int s = t >> 1, c = t & 1;
    Fp x, y;
    if (s == 0) {
      ld(x, S, kQ + c);
      xi_c(y, S, kQ + 2, c);
    } else if (s == 1) {
      xi_c(x, S, kQ + 4, c);
      ld(y, S, kQ + 6 + c);
    } else {
      ld(x, S, kQ + 8 + c);
      ld(y, S, kQ + 10 + c);
    }
    sub(x, x, y);
    st(S, Cn + t, x);
  });
  // Tt = N0 Cn0 + xi (N2 Cn1 + N1 Cn2)
  fp2_products(w, S, 3, N, 0x120u, Cn, 0x210u, kQ);
  w.phase([&](int t) {
    if (t >= 2) return;
    Fp w0, w1, u;
    ld(w0, S, kQ + 2);
    ld(u, S, kQ + 4);
    add(w0, w0, u);
    ld(w1, S, kQ + 3);
    ld(u, S, kQ + 5);
    add(w1, w1, u);
    if (t) {
      add(w0, w0, w1);
    } else {
      sub(w0, w0, w1);
    }
    ld(u, S, kQ + t);
    add(w0, w0, u);
    st(S, Tt + t, w0);
  });
  // Ti = (Tt0 - Tt1 u) / (Tt0^2 + Tt1^2)
  w.phase([&](int t) {
    if (t >= 2) return;
    Fp x;
    ld(x, S, Tt + t);
    mul(x, x, x);
    st(S, kP + t, x);
  });
  w.phase([&](int t) {
    if (t != 0) return;
    Fp n, u;
    ld(n, S, kP);
    ld(u, S, kP + 1);
    add(n, n, u);
    fp_inv_euclid(u, n);
    st(S, Tt + 2, u);
  });
  w.phase([&](int t) {
    if (t >= 2) return;
    Fp x, n;
    ld(x, S, Tt + t);
    ld(n, S, Tt + 2);
    mul(x, x, n);
    if (t) neg(x, x);
    st(S, Ti + t, x);
  });
  // Ni = Cn Ti
  fp2_products(w, S, 3, Cn, 0x210u, Ti, 0x000u, Ni);
  // kT = (a0 Ni, -(a1 Ni))
  fp6_products(w, S, 2, a | (a + 6) << 8, Ni | Ni << 8);
  w.phase([&](int t) {
    if (t >= 12) return;
    Fp x;
    ld(x, S, kP + 18 + t);
    if (t >= 6) neg(x, x);
    st(S, kT + t, x);
  });
}

// ---------------------------------------------------------------- the program

TWW_INL constexpr uint32_t op(uint32_t code, int d, int a, int b) {
  return code | (uint32_t)d << 8 | (uint32_t)a << 16 | (uint32_t)b << 24;
}

// After kT = kF^-1: the easy part's (p^6 - 1)(p^2 + 1), then the HHT hard
// part of ops/pairing.py `_hard_part`, as tower.cuh's final_exponentiation;
// kOpPow d a is d = a^|x|; the result ends in kC.
TWW_INL uint32_t program(int m) {
  switch (m) {
    case 0: return op(kOpConj, kC, kF, 0);
    case 1: return op(kOpMul, kF, kC, kT);   // f^(p^6 - 1)
    case 2: return op(kOpFrob, kT, kF, 2);
    case 3: return op(kOpMul, kF, kT, kF);   // ^(p^2 + 1): cyclotomic now
    case 4: return op(kOpPow, kA, kF, 0);
    case 5: return op(kOpMul, kA, kA, kF);
    case 6: return op(kOpConj, kA, kA, 0);   // a = f^(x - 1)
    case 7: return op(kOpPow, kB, kA, 0);
    case 8: return op(kOpMul, kB, kB, kA);
    case 9: return op(kOpConj, kA, kB, 0);   // a = a^(x - 1)
    case 10: return op(kOpPow, kB, kA, 0);
    case 11: return op(kOpConj, kB, kB, 0);
    case 12: return op(kOpFrob, kT, kA, 1);
    case 13: return op(kOpMul, kB, kB, kT);  // b = a^x frob1(a)
    case 14: return op(kOpPow, kC, kB, 0);
    case 15: return op(kOpConj, kC, kC, 0);
    case 16: return op(kOpPow, kT, kC, 0);
    case 17: return op(kOpConj, kC, kT, 0);  // c = b^(x^2)
    case 18: return op(kOpFrob, kT, kB, 2);
    case 19: return op(kOpMul, kC, kC, kT);
    case 20: return op(kOpConj, kT, kB, 0);
    case 21: return op(kOpMul, kC, kC, kT);  // c = b^(x^2) frob2(b) conj(b)
    case 22: return op(kOpMul, kT, kF, kF);
    case 23: return op(kOpMul, kT, kT, kF);  // f^3
    case 24: return op(kOpMul, kC, kC, kT);
    default: return op(kOpEnd, 0, 0, 0);
  }
}

// Run `program`, a kOpPow expanded into a copy, then per bit of |x| after
// the leading one a cyclotomic squaring and, on a set bit, a product: one
// operation per iteration, so each operation is inlined once.
template <class Warp>
TWW_INL void run_program(Warp& w, uint32_t* S) {
  int m = 0;
  int bit = 63;  // inside a kOpPow: 63 before the copy, then the bit to square for
  bool mul_pending = false;
#pragma unroll 1
  for (;;) {
    const uint32_t ins = program(m);
    uint32_t code = ins & 0xff;
    int d = (ins >> 8) & 0xff, a = (ins >> 16) & 0xff, b = (int)(ins >> 24);
    if (code == kOpEnd) break;
    if (code == kOpPow) {
      if (bit == 63) {
        code = kOpCopy;
        bit = 62;
      } else if (mul_pending) {
        code = kOpMul;
        b = a;
        a = d;
        mul_pending = false;
      } else {
        code = kOpCyc;
        a = d;
        mul_pending = (tw::kXAbs >> bit) & 1;
        bit--;
      }
      if (bit < 0 && !mul_pending) {
        bit = 63;
        m++;
      }
    } else {
      m++;
    }
    switch (code) {
      case kOpMul:
        fp12_mul(w, S, d, a, b);
        break;
      case kOpCyc:
        cyclotomic_sqr(w, S, d, a);
        break;
      case kOpFrob:
        frobenius(w, S, d, a, b);
        break;
      default:  // kOpConj, kOpCopy
        copy12(w, S, d, a, code == kOpConj);
        break;
    }
  }
}

// The final exponentiation of the Fp12 value already in slots kF of the
// kSlotWords-word buffer S, by the warp `w`; the result ends in kC.
template <class Warp>
TWW_INL void final_exp_slots(Warp& w, uint32_t* S) {
  fp12_inv(w, S);
  run_program(w, S);
}

// the Fp12 value at slot `src` of S out as (2, 3, 2, 32) canonical limbs
template <class Warp>
TWW_INL void store12(Warp& w, const uint32_t* S, int src, int32_t* out) {
  w.phase([&](int t) {
    if (t >= 12) return;
    Fp x;
    ld(x, S, src + t);
    fpm::unpack(out + fpm::kLimbs * t, x.w);
  });
}

// The final exponentiation f^((p^12 - 1)/r * 3) of one (2, 3, 2, 32) limb
// lane, canonical limbs out (zero in, zero out), by the warp `w` over the
// kSlotWords-word buffer S.
template <class Warp>
TWW_INL void final_exp_warp(Warp& w, uint32_t* S, const int32_t* in, int32_t* out) {
  w.phase([&](int t) {
    if (t >= 12) return;
    Fp x;
    load_limbs(x, in + fpm::kLimbs * t);
    st(S, kF + t, x);
  });
  final_exp_slots(w, S);
  store12(w, S, kC, out);
}

}  // namespace tww
