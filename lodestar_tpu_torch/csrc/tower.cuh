// The BLS12-381 tower, the optimal ate Miller loop and the final
// exponentiation on 12 x 32-bit words: one thread per lane for the CUDA
// kernel K2 (tower.cu), the types and constants of K2p's, K3-fe's and
// K3's warp schedules (miller_warp.cuh, tower_warp.cuh), and the host
// harness (tower_host.cpp) that the CPU tests build with a C++ compiler,
// where the one-thread lanes of K2p (`miller_proj_lane`), K3-fe
// (`final_exp_lane`) and K3 (`pairing_lane`) stay as their oracles and
// give their bounds' counts.
//
// Representation: an Fp element is 12 little-endian 32-bit words in
// Montgomery form (R = 2^384), the value of the tensor tower's 32 x 12-bit
// limbs. Tensors are packed once at entry (`load_fp`), every operation
// keeps its result FULLY REDUCED in [0, p), and results are unpacked once
// at exit (`store_fp`): canonical limbs, which are also a valid lazy input
// in [0, 2p) for the plain PyTorch tower. The multiply is fp_mont.cuh's
// CIOS (output < 2p for inputs < 2p) followed by one conditional
// subtraction.
//
// Formulas: Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi) with xi = 1 + u,
// Fp12 = Fp6[w]/(w^2 - v), as in ops/fp2.py, fp6.py, fp12.py. The Miller
// loop's line and point formulas are those of ops/pairing.py
// (`_line_and_double`, `_line_and_add` for affine Q, the lines scaled by
// factors the final exponentiation annihilates), through the host C tier's
// one-to-one copies `pair_line_dbl`/`pair_line_add` (csrc/host/bls12.c), and
// for projective P and Q (`line_double_proj`, `line_add_projq`) those of
// `_line_and_double` with zp and `_line_and_add_projq` directly, so the
// Miller value is the same Fp12 element as the plain version's; the
// tower products may be computed by other (Karatsuba or schoolbook) forms
// because only the field value matters. The final exponentiation is the
// easy part (p^6 - 1)(p^2 + 1) with a per-thread Fermat inversion (zero in,
// zero out: the zero-lane guard of `final_exponentiation_batch`) and the
// HHT hard part with Granger-Scott cyclotomic squarings (pairing^3).
//
// In device code every non-trivial function is __noinline__: K2 is one
// thread per lane, and inlining the whole loop would make code of
// hundreds of thousands of instructions (slow to compile, no faster while
// the working set lives in local memory anyway). Defining TOWER_COUNT_MULS
// (the host harness does) counts Fp multiplies in `tw_fp_muls`, which gives
// the kernels' operation bound.
#pragma once

#include <stdint.h>

#include "fp_mont.cuh"

#ifdef __CUDACC__
#define TW_FN __host__ __device__ __noinline__
#define TW_INL __host__ __device__ __forceinline__
#else
#define TW_FN inline
#define TW_INL inline
#endif

#ifdef TOWER_COUNT_MULS
extern unsigned long long tw_fp_muls;
#define TW_COUNT_MUL() (++tw_fp_muls)
#else
#define TW_COUNT_MUL() ((void)0)
#endif

#include "tower_consts.cuh"

namespace tw {

constexpr int kW = fpm::kWords;  // 12 words of 32 bits
constexpr int kLimbs = fpm::kLimbs;  // 32 limbs of 12 bits
// |x| for the BLS parameter x = -0xd201000000010000 (bit 63 is the top bit)
constexpr uint64_t kXAbs = 0xd201000000010000ull;

struct Fp { uint32_t w[kW]; };
struct Fp2 { Fp c0, c1; };
struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };
struct G2 { Fp2 x, y, z; };  // homogeneous projective on the twist

// ---------------------------------------------------------------- Fp

TW_INL void fp_zero(Fp& r) {
  for (int i = 0; i < kW; i++) r.w[i] = 0;
}
TW_INL void fp_one(Fp& r) { consts::one(r.w); }

// r = s - p if s >= p, else s (s < 2^384)
TW_INL void fp_reduce_once(Fp& r, const uint32_t s[kW]) {
  uint32_t p[kW], t[kW];
  fpm::load_p(p);
  uint64_t borrow = 0;
  for (int i = 0; i < kW; i++) {
    const uint64_t d = (uint64_t)s[i] - p[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
  for (int i = 0; i < kW; i++) r.w[i] = borrow ? s[i] : t[i];
}

TW_FN void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[kW];
  uint64_t c = 0;
  for (int i = 0; i < kW; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, s);  // a + b < 2p < 2^382: no carry out
}

TW_FN void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t p[kW], t[kW];
  fpm::load_p(p);
  uint64_t borrow = 0;
  for (int i = 0; i < kW; i++) {
    const uint64_t d = (uint64_t)a.w[i] - b.w[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
  uint64_t c = 0;
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // a < b: add p back
  for (int i = 0; i < kW; i++) {
    c += (uint64_t)t[i] + (p[i] & mask);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

TW_INL void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

TW_FN void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  TW_COUNT_MUL();
  uint32_t t[kW];
  fpm::mont_mul_words(t, a.w, b.w);  // < 2p for a, b < p
  fp_reduce_once(r, t);
}

// a^(p-2): the Fermat inverse, square-and-multiply from bit 380 of p - 2;
// 0 maps to 0
TW_FN void fp_inv(Fp& r, const Fp& a) {
  uint32_t e[kW];
  consts::p_minus_2(e);
  Fp acc;
  fp_one(acc);
  for (int bit = 380; bit >= 0; bit--) {
    fp_mul(acc, acc, acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1) fp_mul(acc, acc, a);
  }
  r = acc;
}

// 32 limbs of 12 bits -> a reduced element. Limbs are masked to 12 bits
// and the value is brought below p by at most 9 subtractions (2^384 < 10p),
// so any input, padding and garbage lanes included, stays in range.
TW_FN void load_fp(Fp& r, const int32_t* limbs) {
  int32_t l[kLimbs];
  for (int i = 0; i < kLimbs; i++) l[i] = limbs[i] & 0xfff;
  uint32_t s[kW];
  fpm::pack(s, l);
  for (int k = 0; k < 9; k++) {
    fp_reduce_once(r, s);
    for (int i = 0; i < kW; i++) s[i] = r.w[i];
  }
  fp_reduce_once(r, s);
}

TW_FN void store_fp(int32_t* limbs, const Fp& a) { fpm::unpack(limbs, a.w); }

// ---------------------------------------------------------------- Fp2

TW_INL void fp2_zero(Fp2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}
TW_INL void fp2_one(Fp2& r) {
  fp_one(r.c0);
  fp_zero(r.c1);
}

TW_FN void fp2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}
TW_FN void fp2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}
TW_FN void fp2_neg(Fp2& r, const Fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}
TW_FN void fp2_conj(Fp2& r, const Fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}
TW_INL void fp2_double(Fp2& r, const Fp2& a) { fp2_add(r, a, a); }

// Karatsuba: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
TW_FN void fp2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, sa, sb, m;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(m, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(m, m, t0);
  fp_sub(r.c1, m, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u
TW_FN void fp2_sqr(Fp2& r, const Fp2& a) {
  Fp s, d, m, c;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(c, s, d);
  r.c0 = c;
  fp_add(r.c1, m, m);
}

TW_FN void fp2_mul_fp(Fp2& r, const Fp2& a, const Fp& k) {
  fp_mul(r.c0, a.c0, k);
  fp_mul(r.c1, a.c1, k);
}

// xi (a0 + a1 u) = (a0 - a1) + (a0 + a1) u
TW_FN void fp2_mul_xi(Fp2& r, const Fp2& a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

// (a0 - a1 u) / (a0^2 + a1^2); 0 maps to 0
TW_FN void fp2_inv(Fp2& r, const Fp2& a) {
  Fp n0, n1, n;
  fp_mul(n0, a.c0, a.c0);
  fp_mul(n1, a.c1, a.c1);
  fp_add(n, n0, n1);
  fp_inv(n, n);
  Fp c1;
  fp_mul(r.c0, a.c0, n);
  fp_mul(c1, a.c1, n);
  fp_neg(r.c1, c1);
}

TW_FN void load_fp2(Fp2& r, const int32_t* limbs) {
  load_fp(r.c0, limbs);
  load_fp(r.c1, limbs + kLimbs);
}

// ---------------------------------------------------------------- Fp6

TW_INL void fp6_zero(Fp6& r) {
  fp2_zero(r.c0);
  fp2_zero(r.c1);
  fp2_zero(r.c2);
}
TW_INL void fp6_one(Fp6& r) {
  fp2_one(r.c0);
  fp2_zero(r.c1);
  fp2_zero(r.c2);
}

TW_FN void fp6_add(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}
TW_FN void fp6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}
TW_FN void fp6_neg(Fp6& r, const Fp6& a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// Karatsuba over v with v^3 = xi (6 Fp2 products)
TW_FN void fp6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
  Fp2 v0, v1, v2, sa, sb, t, s;
  Fp6 out;
  fp2_mul(v0, a.c0, b.c0);
  fp2_mul(v1, a.c1, b.c1);
  fp2_mul(v2, a.c2, b.c2);
  // c0 = v0 + xi((a1 + a2)(b1 + b2) - v1 - v2)
  fp2_add(sa, a.c1, a.c2);
  fp2_add(sb, b.c1, b.c2);
  fp2_mul(t, sa, sb);
  fp2_sub(t, t, v1);
  fp2_sub(t, t, v2);
  fp2_mul_xi(t, t);
  fp2_add(out.c0, v0, t);
  // c1 = (a0 + a1)(b0 + b1) - v0 - v1 + xi v2
  fp2_add(sa, a.c0, a.c1);
  fp2_add(sb, b.c0, b.c1);
  fp2_mul(t, sa, sb);
  fp2_sub(t, t, v0);
  fp2_sub(t, t, v1);
  fp2_mul_xi(s, v2);
  fp2_add(out.c1, t, s);
  // c2 = (a0 + a2)(b0 + b2) - v0 - v2 + v1
  fp2_add(sa, a.c0, a.c2);
  fp2_add(sb, b.c0, b.c2);
  fp2_mul(t, sa, sb);
  fp2_sub(t, t, v0);
  fp2_sub(t, t, v2);
  fp2_add(out.c2, t, v1);
  r = out;
}

// v (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
TW_FN void fp6_mul_by_v(Fp6& r, const Fp6& a) {
  Fp2 t, c0 = a.c0, c1 = a.c1;
  fp2_mul_xi(t, a.c2);
  r.c0 = t;
  r.c1 = c0;
  r.c2 = c1;
}

// c0 = a0^2 - xi a1 a2, c1 = xi a2^2 - a0 a1, c2 = a1^2 - a0 a2,
// t = a0 c0 + xi (a2 c1 + a1 c2), a^-1 = c / t; 0 maps to 0
TW_FN void fp6_inv(Fp6& r, const Fp6& a) {
  Fp2 c0, c1, c2, t, s, u;
  fp2_sqr(c0, a.c0);
  fp2_mul(t, a.c1, a.c2);
  fp2_mul_xi(t, t);
  fp2_sub(c0, c0, t);
  fp2_sqr(c1, a.c2);
  fp2_mul_xi(c1, c1);
  fp2_mul(t, a.c0, a.c1);
  fp2_sub(c1, c1, t);
  fp2_sqr(c2, a.c1);
  fp2_mul(t, a.c0, a.c2);
  fp2_sub(c2, c2, t);
  fp2_mul(t, a.c0, c0);
  fp2_mul(s, a.c2, c1);
  fp2_mul(u, a.c1, c2);
  fp2_add(s, s, u);
  fp2_mul_xi(s, s);
  fp2_add(t, t, s);
  fp2_inv(t, t);
  fp2_mul(r.c0, c0, t);
  fp2_mul(r.c1, c1, t);
  fp2_mul(r.c2, c2, t);
}

// ---------------------------------------------------------------- Fp12

TW_INL void fp12_one(Fp12& r) {
  fp6_one(r.c0);
  fp6_zero(r.c1);
}

TW_FN void fp12_conj(Fp12& r, const Fp12& a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

// Karatsuba over w: c0 = v0 + v v1, c1 = (a0 + a1)(b0 + b1) - v0 - v1
TW_FN void fp12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
  Fp6 v0, v1, sa, sb, t;
  fp6_mul(v0, a.c0, b.c0);
  fp6_mul(v1, a.c1, b.c1);
  fp6_add(sa, a.c0, a.c1);
  fp6_add(sb, b.c0, b.c1);
  fp6_mul(t, sa, sb);
  fp6_sub(t, t, v0);
  fp6_sub(r.c1, t, v1);
  fp6_mul_by_v(v1, v1);
  fp6_add(r.c0, v0, v1);
}

// complex squaring: c0 = (a0 + a1)(a0 + v a1) - v0 - v v0, c1 = 2 v0
TW_FN void fp12_sqr(Fp12& r, const Fp12& a) {
  Fp6 v0, t0, t1;
  fp6_mul(v0, a.c0, a.c1);
  fp6_add(t0, a.c0, a.c1);
  fp6_mul_by_v(t1, a.c1);
  fp6_add(t1, a.c0, t1);
  fp6_mul(t0, t0, t1);
  fp6_sub(t0, t0, v0);
  fp6_mul_by_v(t1, v0);
  fp6_sub(r.c0, t0, t1);
  fp6_add(r.c1, v0, v0);
}

// (c0 - c1 w) / (c0^2 - v c1^2); 0 maps to 0
TW_FN void fp12_inv(Fp12& r, const Fp12& a) {
  Fp6 t0, t1;
  fp6_mul(t0, a.c0, a.c0);
  fp6_mul(t1, a.c1, a.c1);
  fp6_mul_by_v(t1, t1);
  fp6_sub(t0, t0, t1);
  fp6_inv(t0, t0);
  fp6_mul(t1, a.c1, t0);
  fp6_mul(r.c0, a.c0, t0);
  fp6_neg(r.c1, t1);
}

// f * (a0 + a1 v)
TW_FN void fp6_mul_sparse01(Fp6& r, const Fp6& f, const Fp2& a0, const Fp2& a1) {
  Fp2 t0, t1, t2;
  Fp6 out;
  fp2_mul(t0, f.c0, a0);
  fp2_mul(t1, f.c2, a1);
  fp2_mul_xi(t1, t1);
  fp2_add(out.c0, t0, t1);
  fp2_mul(t0, f.c0, a1);
  fp2_mul(t1, f.c1, a0);
  fp2_add(out.c1, t0, t1);
  fp2_mul(t1, f.c1, a1);
  fp2_mul(t2, f.c2, a0);
  fp2_add(out.c2, t1, t2);
  r = out;
}

// f * (b1 v)
TW_FN void fp6_mul_sparse1(Fp6& r, const Fp6& f, const Fp2& b1) {
  Fp2 t;
  Fp6 out;
  fp2_mul(t, f.c2, b1);
  fp2_mul_xi(out.c0, t);
  fp2_mul(out.c1, f.c0, b1);
  fp2_mul(out.c2, f.c1, b1);
  r = out;
}

// f *= l0 + l1 w^2 + l2 w^3, i.e. f * (A + B w) with A = (l0, l1, 0),
// B = (0, l2, 0): the sparse line update of ops/fp12.py mul_by_line
TW_FN void fp12_mul_by_line(Fp12& f, const Fp2& l0, const Fp2& l1, const Fp2& l2) {
  Fp6 t0, t1, t2, g;
  Fp2 s;
  fp6_mul_sparse01(t0, f.c0, l0, l1);
  fp6_mul_sparse1(t1, f.c1, l2);
  fp6_add(g, f.c0, f.c1);
  fp2_add(s, l1, l2);
  fp6_mul_sparse01(t2, g, l0, s);
  fp6_sub(t2, t2, t0);
  fp6_sub(f.c1, t2, t1);
  fp6_mul_by_v(t1, t1);
  fp6_add(f.c0, t0, t1);
}

// x^(p^k), k = 1..3: the w-coefficients (c00, c10, c01, c11, c02, c12),
// conjugated for odd k, times gamma_i^(k)
TW_FN void fp12_frobenius(Fp12& r, const Fp12& a, int k) {
  const Fp2* d[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1, &a.c1.c1, &a.c0.c2, &a.c1.c2};
  Fp12 out;
  Fp2* o[6] = {&out.c0.c0, &out.c1.c0, &out.c0.c1, &out.c1.c1, &out.c0.c2, &out.c1.c2};
  for (int i = 0; i < 6; i++) {
    Fp2 t, g;
    if (k & 1) {
      fp2_conj(t, *d[i]);
    } else {
      t = *d[i];
    }
    consts::gamma(g.c0.w, g.c1.w, k, i);
    fp2_mul(*o[i], t, g);
  }
  r = out;
}

// Granger-Scott squaring, valid in the cyclotomic subgroup (and 0 -> 0):
// with c0 = (a, b, c), c1 = (d, e, f),
//   t0 = a^2 + xi e^2, t2 = d^2 + xi c^2, t4 = b^2 + xi f^2,
//   t6 = 2ae, t7 = 2cd, t8 = 2bf xi,
//   c0' = (3t0 - 2a, 3t2 - 2b, 3t4 - 2c), c1' = (3t8 + 2d, 3t6 + 2e, 3t7 + 2f)
TW_FN void fp12_cyclotomic_sqr(Fp12& r, const Fp12& g) {
  const Fp2 &a = g.c0.c0, &b = g.c0.c1, &c = g.c0.c2;
  const Fp2 &d = g.c1.c0, &e = g.c1.c1, &f = g.c1.c2;
  Fp2 a2, e2, c2, d2, b2, f2, t, t0, t2, t4, t6, t7, t8;
  fp2_sqr(a2, a);
  fp2_sqr(e2, e);
  fp2_sqr(c2, c);
  fp2_sqr(d2, d);
  fp2_sqr(b2, b);
  fp2_sqr(f2, f);
  fp2_add(t, a, e);
  fp2_sqr(t, t);
  fp2_sub(t, t, a2);
  fp2_sub(t6, t, e2);
  fp2_add(t, c, d);
  fp2_sqr(t, t);
  fp2_sub(t, t, c2);
  fp2_sub(t7, t, d2);
  fp2_add(t, b, f);
  fp2_sqr(t, t);
  fp2_sub(t, t, b2);
  fp2_sub(t, t, f2);
  fp2_mul_xi(t8, t);
  fp2_mul_xi(t, e2);
  fp2_add(t0, t, a2);
  fp2_mul_xi(t, c2);
  fp2_add(t2, t, d2);
  fp2_mul_xi(t, f2);
  fp2_add(t4, t, b2);
  const Fp2* tv[6] = {&t0, &t2, &t4, &t8, &t6, &t7};
  const Fp2* xv[6] = {&a, &b, &c, &d, &e, &f};
  Fp12 out;
  Fp2* o[6] = {&out.c0.c0, &out.c0.c1, &out.c0.c2, &out.c1.c0, &out.c1.c1, &out.c1.c2};
  for (int i = 0; i < 6; i++) {
    Fp2 y;
    if (i < 3) {
      fp2_sub(y, *tv[i], *xv[i]);  // 2(t - x) + t
    } else {
      fp2_add(y, *tv[i], *xv[i]);  // 2(t + x) + t
    }
    fp2_double(y, y);
    fp2_add(*o[i], y, *tv[i]);
  }
  r = out;
}

TW_FN void store_fp12(int32_t* limbs, const Fp12& a) {
  const Fp6* six[2] = {&a.c0, &a.c1};
  for (int h = 0; h < 2; h++) {
    const Fp2* two[3] = {&six[h]->c0, &six[h]->c1, &six[h]->c2};
    for (int j = 0; j < 3; j++) {
      store_fp(limbs + (h * 6 + j * 2) * kLimbs, two[j]->c0);
      store_fp(limbs + (h * 6 + j * 2 + 1) * kLimbs, two[j]->c1);
    }
  }
}

TW_FN void load_fp12(Fp12& r, const int32_t* limbs) {
  Fp6* six[2] = {&r.c0, &r.c1};
  for (int h = 0; h < 2; h++) {
    Fp2* two[3] = {&six[h]->c0, &six[h]->c1, &six[h]->c2};
    for (int j = 0; j < 3; j++) load_fp2(*two[j], limbs + (h * 6 + j * 2) * kLimbs);
  }
}

// ---------------------------------------------------------------- Miller loop

TW_INL void twist_b3(Fp2& r) { consts::b3(r.c0.w, r.c1.w); }

// Tangent line at T and T <- 2T (RCB16 Algorithm 9, a = 0), the line
// scaled by 2YZ^2 w^3: l0 = 3X^3 - 2Y^2 Z, l1 = 3X^2 Z (-xp), l2 = 2YZ^2 yp
// (ops/pairing.py `_line_and_double` with zp = None)
TW_FN void line_double(Fp2& l0, Fp2& l1, Fp2& l2, G2& t, const Fp& xp_neg, const Fp& yp) {
  Fp2 b3, xx, yy, zz, yz, xy, xxx, yyz, xxz, yzz, t2b, s;
  twist_b3(b3);
  fp2_sqr(xx, t.x);
  fp2_sqr(yy, t.y);
  fp2_sqr(zz, t.z);
  fp2_mul(yz, t.y, t.z);
  fp2_mul(xy, t.x, t.y);
  fp2_mul(xxx, xx, t.x);
  fp2_mul(yyz, yy, t.z);
  fp2_mul(xxz, xx, t.z);
  fp2_mul(yzz, yz, t.z);
  fp2_mul(t2b, b3, zz);
  fp2_add(l0, xxx, xxx);
  fp2_add(l0, l0, xxx);
  fp2_double(s, yyz);
  fp2_sub(l0, l0, s);
  Fp2 three_xxz, two_yzz;
  fp2_add(three_xxz, xxz, xxz);
  fp2_add(three_xxz, three_xxz, xxz);
  fp2_mul_fp(l1, three_xxz, xp_neg);
  fp2_double(two_yzz, yzz);
  fp2_mul_fp(l2, two_yzz, yp);
  Fp2 z8, y3s, t0c;
  fp2_double(z8, yy);
  fp2_double(z8, z8);
  fp2_double(z8, z8);  // 8 Y^2
  fp2_add(y3s, yy, t2b);
  fp2_add(s, t2b, t2b);
  fp2_add(s, s, t2b);
  fp2_sub(t0c, yy, s);  // Y^2 - 3 b3 Z^2
  Fp2 x3, z3, y3m, xt;
  fp2_mul(x3, t2b, z8);
  fp2_mul(z3, yz, z8);
  fp2_mul(y3m, t0c, y3s);
  fp2_mul(xt, t0c, xy);
  fp2_double(t.x, xt);
  fp2_add(t.y, x3, y3m);
  t.z = z3;
}

// Chord line through T and affine Q and T <- T + Q (RCB16 Algorithm 8,
// a = 0): with theta = Y - yq Z and H = X - xq Z,
// l0 = theta xq - yq H, l1 = theta (-xp), l2 = H yp
// (ops/pairing.py `_line_and_add` with zp = None)
TW_FN void line_add(Fp2& l0, Fp2& l1, Fp2& l2, G2& t, const Fp2& xq, const Fp2& yq,
                    const Fp& xp_neg, const Fp& yp) {
  Fp2 b3, t0, t1, u, xqz, yqz, b3z, s;
  twist_b3(b3);
  fp2_mul(t0, t.x, xq);
  fp2_mul(t1, t.y, yq);
  fp2_add(u, t.x, t.y);
  fp2_add(s, xq, yq);
  fp2_mul(u, u, s);  // (X + Y)(xq + yq)
  fp2_mul(xqz, xq, t.z);
  fp2_mul(yqz, yq, t.z);
  fp2_mul(b3z, b3, t.z);
  Fp2 theta, h, thxq, yqh;
  fp2_sub(theta, t.y, yqz);
  fp2_sub(h, t.x, xqz);
  fp2_mul(thxq, theta, xq);
  fp2_mul(yqh, yq, h);
  fp2_sub(l0, thxq, yqh);
  fp2_mul_fp(l1, theta, xp_neg);
  fp2_mul_fp(l2, h, yp);
  Fp2 t3, y3p, t4, x3, z3, t1m, y3;
  fp2_sub(t3, u, t0);
  fp2_sub(t3, t3, t1);
  fp2_add(y3p, xqz, t.x);
  fp2_add(t4, yqz, t.y);
  fp2_add(x3, t0, t0);
  fp2_add(x3, x3, t0);
  fp2_add(z3, t1, b3z);
  fp2_sub(t1m, t1, b3z);
  fp2_mul(y3, b3, y3p);
  Fp2 pa, pb, pc, pd, pe, pf;
  fp2_mul(pa, t3, t1m);
  fp2_mul(pb, t4, y3);
  fp2_mul(pc, y3, x3);
  fp2_mul(pd, t1m, z3);
  fp2_mul(pe, z3, t4);
  fp2_mul(pf, x3, t3);
  fp2_sub(t.x, pa, pb);
  fp2_add(t.y, pc, pd);
  fp2_add(t.z, pe, pf);
}

// line_double for P = (Xp, Yp, Zp) homogeneous projective: Xp and Yp as
// they stand, then l0 scaled by Zp (ops/pairing.py `_line_and_double`)
TW_FN void line_double_proj(Fp2& l0, Fp2& l1, Fp2& l2, G2& t, const Fp& xp_neg, const Fp& yp,
                            const Fp& zp) {
  line_double(l0, l1, l2, t, xp_neg, yp);
  fp2_mul_fp(l0, l0, zp);
}

// Chord line through T and projective Q = (Xq, Yq, Zq) and T <- T + Q
// (RCB16 Algorithm 7, a = 0), the line scaled by Zq^2: with
// theta' = Y Zq - Yq Z and H' = X Zq - Xq Z,
// l0 = (theta' Xq - Yq H') Zp, l1 = (Zq theta') (-Xp), l2 = (Zq H') Yp
// (ops/pairing.py `_line_and_add_projq`, formula for formula)
TW_FN void line_add_projq(Fp2& l0, Fp2& l1, Fp2& l2, G2& t, const G2& q, const Fp& xp_neg,
                          const Fp& yp, const Fp& zp) {
  Fp2 b3, t0, t1, t2, u, s, yzq, yqz, xzq, xqz;
  twist_b3(b3);
  fp2_mul(t0, t.x, q.x);
  fp2_mul(t1, t.y, q.y);
  fp2_mul(t2, t.z, q.z);
  fp2_add(u, t.x, t.y);
  fp2_add(s, q.x, q.y);
  fp2_mul(u, u, s);  // (X + Y)(Xq + Yq)
  fp2_mul(yzq, t.y, q.z);
  fp2_mul(yqz, q.y, t.z);
  fp2_mul(xzq, t.x, q.z);
  fp2_mul(xqz, q.x, t.z);
  Fp2 theta, h, t3, t4, y3p, x3;
  fp2_sub(theta, yzq, yqz);
  fp2_sub(h, xzq, xqz);
  fp2_sub(t3, u, t0);
  fp2_sub(t3, t3, t1);
  fp2_add(t4, yzq, yqz);
  fp2_add(y3p, xzq, xqz);
  fp2_add(x3, t0, t0);
  fp2_add(x3, x3, t0);
  Fp2 t2b, thxq, yqh, thz, hz, y3, z3, t1m;
  fp2_mul(t2b, b3, t2);
  fp2_mul(thxq, theta, q.x);
  fp2_mul(yqh, q.y, h);
  fp2_mul(thz, q.z, theta);
  fp2_mul(hz, q.z, h);
  fp2_mul(y3, b3, y3p);
  fp2_sub(l0, thxq, yqh);
  fp2_add(z3, t1, t2b);
  fp2_sub(t1m, t1, t2b);
  fp2_mul_fp(l1, thz, xp_neg);
  fp2_mul_fp(l2, hz, yp);
  fp2_mul_fp(l0, l0, zp);
  Fp2 pa, pb, pc, pd, pe, pf;
  fp2_mul(pa, t3, t1m);
  fp2_mul(pb, t4, y3);
  fp2_mul(pc, y3, x3);
  fp2_mul(pd, t1m, z3);
  fp2_mul(pe, z3, t4);
  fp2_mul(pf, x3, t3);
  fp2_sub(t.x, pa, pb);
  fp2_add(t.y, pc, pd);
  fp2_add(t.z, pe, pf);
}

// conj(f_{|x|,Q}(P)) for affine P = (xp, yp) and Q = (xq, yq): the bits of
// |x| after the leading one, MSB first; f <- f^2 * line_double, and on a set
// bit f <- f * line_add
TW_FN void miller_loop(Fp12& f, const Fp& xp, const Fp& yp, const Fp2& xq, const Fp2& yq) {
  Fp xp_neg;
  fp_neg(xp_neg, xp);
  G2 t;
  t.x = xq;
  t.y = yq;
  fp2_one(t.z);
  fp12_one(f);
  Fp2 l0, l1, l2;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(f, f);
    line_double(l0, l1, l2, t, xp_neg, yp);
    fp12_mul_by_line(f, l0, l1, l2);
    if ((kXAbs >> i) & 1) {
      line_add(l0, l1, l2, t, xq, yq, xp_neg, yp);
      fp12_mul_by_line(f, l0, l1, l2);
    }
  }
  fp12_conj(f, f);  // x < 0
}

// conj(f_{|x|,Q}(P)) for P = (xp, yp, zp) and Q both homogeneous
// projective (ops/pairing.py `miller_loop_proj_pq`): T starts at Q, and
// every line carries the plain loop's scaling, so f is the same Fp12
// element lane for lane. Zp = 0 or Zq = 0 gives some value (the callers
// mask those lanes); nothing divides, so nothing faults.
TW_FN void miller_loop_proj(Fp12& f, const Fp& xp, const Fp& yp, const Fp& zp, const G2& q) {
  Fp xp_neg;
  fp_neg(xp_neg, xp);
  G2 t = q;
  fp12_one(f);
  Fp2 l0, l1, l2;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(f, f);
    line_double_proj(l0, l1, l2, t, xp_neg, yp, zp);
    fp12_mul_by_line(f, l0, l1, l2);
    if ((kXAbs >> i) & 1) {
      line_add_projq(l0, l1, l2, t, q, xp_neg, yp, zp);
      fp12_mul_by_line(f, l0, l1, l2);
    }
  }
  fp12_conj(f, f);  // x < 0
}

// conj(f_{|x|,Q1}(P1) * f_{|x|,Q2}(P2)) with ONE squaring chain: squaring
// distributes over the product, so this is the product of the two loops'
// values, with half the Fp12 squarings
TW_FN void miller_loop2(Fp12& f, const Fp& p1x, const Fp& p1y, const Fp2& q1x, const Fp2& q1y,
                        const Fp& p2x, const Fp& p2y, const Fp2& q2x, const Fp2& q2y) {
  Fp n1, n2;
  fp_neg(n1, p1x);
  fp_neg(n2, p2x);
  G2 t1, t2;
  t1.x = q1x;
  t1.y = q1y;
  fp2_one(t1.z);
  t2.x = q2x;
  t2.y = q2y;
  fp2_one(t2.z);
  fp12_one(f);
  Fp2 l0, l1, l2;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(f, f);
    line_double(l0, l1, l2, t1, n1, p1y);
    fp12_mul_by_line(f, l0, l1, l2);
    line_double(l0, l1, l2, t2, n2, p2y);
    fp12_mul_by_line(f, l0, l1, l2);
    if ((kXAbs >> i) & 1) {
      line_add(l0, l1, l2, t1, q1x, q1y, n1, p1y);
      fp12_mul_by_line(f, l0, l1, l2);
      line_add(l0, l1, l2, t2, q2x, q2y, n2, p2y);
      fp12_mul_by_line(f, l0, l1, l2);
    }
  }
  fp12_conj(f, f);
}

// ---------------------------------------------------------------- final exponentiation

// g^|x| by cyclotomic squarings (g cyclotomic)
TW_FN void fp12_pow_x_abs(Fp12& r, const Fp12& g) {
  Fp12 acc = g;
  for (int i = 62; i >= 0; i--) {
    fp12_cyclotomic_sqr(acc, acc);
    if ((kXAbs >> i) & 1) fp12_mul(acc, acc, g);
  }
  r = acc;
}

// g^x, x negative: g^|x| then the conjugate (the cyclotomic inverse)
TW_FN void fp12_pow_x(Fp12& r, const Fp12& g) {
  fp12_pow_x_abs(r, g);
  fp12_conj(r, r);
}

// g^(x-1) = g^x * conj(g)
TW_FN void pow_x_minus_1(Fp12& r, const Fp12& g) {
  Fp12 a, c;
  fp12_pow_x(a, g);
  fp12_conj(c, g);
  fp12_mul(r, a, c);
}

// f^((p^12 - 1)/r * 3): the easy part (p^6 - 1)(p^2 + 1) with a Fermat
// inverse, then the HHT hard part of ops/pairing.py `_hard_part`
TW_FN void final_exponentiation(Fp12& r, const Fp12& fin) {
  Fp12 f, t;
  fp12_inv(t, fin);
  fp12_conj(f, fin);
  fp12_mul(f, f, t);  // f^(p^6 - 1)
  fp12_frobenius(t, f, 2);
  fp12_mul(f, t, f);  // ^(p^2 + 1): cyclotomic now
  Fp12 a, b, c;
  pow_x_minus_1(a, f);
  pow_x_minus_1(a, a);
  fp12_pow_x(b, a);
  fp12_frobenius(t, a, 1);
  fp12_mul(b, b, t);  // b = a^x * frob1(a)
  fp12_pow_x(c, b);
  fp12_pow_x(c, c);
  fp12_frobenius(t, b, 2);
  fp12_mul(c, c, t);
  fp12_conj(t, b);
  fp12_mul(c, c, t);  // c = b^(x^2) * frob2(b) * conj(b)
  fp12_mul(t, f, f);
  fp12_mul(t, t, f);  // f^3
  fp12_mul(r, c, t);
}

// ---------------------------------------------------------------- lanes

// K2's lane: (xp, yp) (32,), (xq, yq) (2, 32) limbs -> conj(f_{|x|,Q}(P))
// as (2, 3, 2, 32) canonical limbs
TW_FN void miller_lane(const int32_t* xp, const int32_t* yp, const int32_t* xq,
                       const int32_t* yq, int32_t* out) {
  Fp px, py;
  Fp2 qx, qy;
  load_fp(px, xp);
  load_fp(py, yp);
  load_fp2(qx, xq);
  load_fp2(qy, yq);
  Fp12 f;
  miller_loop(f, px, py, qx, qy);
  store_fp12(out, f);
}

// K2p's lane: (xp, yp, zp) (32,), (xq, yq, zq) (2, 32) limbs ->
// conj(f_{|x|,Q}(P)) for projective P and Q as (2, 3, 2, 32) canonical limbs
TW_FN void miller_proj_lane(const int32_t* xp, const int32_t* yp, const int32_t* zp,
                            const int32_t* xq, const int32_t* yq, const int32_t* zq,
                            int32_t* out) {
  Fp px, py, pz;
  G2 q;
  load_fp(px, xp);
  load_fp(py, yp);
  load_fp(pz, zp);
  load_fp2(q.x, xq);
  load_fp2(q.y, yq);
  load_fp2(q.z, zq);
  Fp12 f;
  miller_loop_proj(f, px, py, pz, q);
  store_fp12(out, f);
}

// K3's lane: final_exp(ML(pk, H(m)) * ML(-g1, sig)) as (2, 3, 2, 32)
// canonical limbs
TW_FN void pairing_lane(const int32_t* pk_x, const int32_t* pk_y, const int32_t* msg_x,
                        const int32_t* msg_y, const int32_t* sig_x, const int32_t* sig_y,
                        int32_t* out) {
  Fp px, py, gx, gy;
  Fp2 hx, hy, sx, sy;
  load_fp(px, pk_x);
  load_fp(py, pk_y);
  load_fp2(hx, msg_x);
  load_fp2(hy, msg_y);
  load_fp2(sx, sig_x);
  load_fp2(sy, sig_y);
  consts::g1_x(gx.w);
  consts::g1_neg_y(gy.w);
  Fp12 f;
  miller_loop2(f, px, py, hx, hy, gx, gy, sx, sy);
  final_exponentiation(f, f);
  store_fp12(out, f);
}

// K3-fe's lane: the final exponentiation of one (2, 3, 2, 32) lane,
// canonical limbs out (zero in, zero out)
TW_FN void final_exp_lane(const int32_t* in, int32_t* out) {
  Fp12 f;
  load_fp12(f, in);
  final_exponentiation(f, f);
  store_fp12(out, f);
}

}  // namespace tw
