// The projective Miller loop with one warp per lane (K2p), shared by the
// CUDA kernel (tower.cu) and the host harness (tower_host.cpp), which
// emulates the warp, over tower_warp.cuh's Fp operations and its `Warp`
// phase runner.
//
// The lane's values live in a buffer of ml::kSlots Fp slots (12 words each,
// fully reduced Montgomery form): P and Q as loaded, f, T, the lane's
// constants (-3xp, 2yp, 3zp, -2zp; Xq zp, Yq zp, Zq (-xp), Zq yp), a + b
// and a + v b of f = a + b w, the next step's first products and the
// step's temporaries. The steps are fixed sequences of phases, given as
// tables (miller_sched.cuh, generated and checked by gen_miller_sched.py)
// that one loop interprets, so each kind of phase is code once:
// - MUL: thread t < n multiplies two operands, each a sum of slots minus a
//   sum of slots, and writes the product to its slot: a round;
// - LIN: thread t < n writes m times a sum of slots minus a sum of slots,
//   m a small integer.
// Each step's line takes two levels of products; the first (over T, Q and
// the lane's constants only) runs in the previous step's last round, beside
// the line product, so there are three templates: a doubling followed by a
// doubling, a doubling followed by an addition, an addition (a doubling
// follows). A doubling step is 4 rounds in 8 phases (the Fp12 squaring's 36
// products, the last 4 beside the line's 24; the line product's 39 and the
// next step's first products), an addition step 3 in 6: 268 rounds and 539
// phases per lane. Every l0, l1, l2 and T is the field element of the plain
// loop (`_line_and_double` with zp, `_line_and_add_projq`), so the result
// equals tower.cuh's one-thread `miller_loop_proj` limb for limb.
//
// K3 runs the same program (`miller_slots`) on two warps per set, loaded
// affine at unit Z by `pairing_load`, and ends with `pairing_tail`: the
// product of the two values, its conjugate and tower_warp.cuh's final
// exponentiation on the first warp's slots.
#pragma once

#include <stdint.h>

#include "miller_sched.cuh"
#include "tower_warp.cuh"

namespace tww {
namespace ml {

#ifdef __CUDACC__
__device__ const uint32_t kPhaseDevice[] = TWW_ML_PHASES;
__device__ const uint8_t kRecDevice[] = TWW_ML_RECORDS;
#endif
static const uint32_t kPhaseHost[] = TWW_ML_PHASES;
static const uint8_t kRecHost[] = TWW_ML_RECORDS;

TWW_INL uint32_t phase_word(int ph) {
#ifdef __CUDA_ARCH__
  return kPhaseDevice[ph];
#else
  return kPhaseHost[ph];
#endif
}

TWW_INL const uint8_t* record(int k) {
#ifdef __CUDA_ARCH__
  return kRecDevice + kRecBytes * k;
#else
  return kRecHost + kRecBytes * k;
#endif
}

// r = S[s_0] + ... + S[s_{np-1}] - (S[s_np] + ... + S[s_{np+nn-1}]), np >= 1
TWW_INL void gather(Fp& r, const uint32_t* S, const uint8_t* s, int np, int nn) {
  Fp u;
  ld(r, S, s[0]);
#pragma unroll 1
  for (int i = 1; i < np; i++) {
    ld(u, S, s[i]);
    add(r, r, u);
  }
  if (nn > 0) {
    Fp g;
    ld(g, S, s[np]);
#pragma unroll 1
    for (int i = 1; i < nn; i++) {
      ld(u, S, s[np + i]);
      add(g, g, u);
    }
    sub(r, r, g);
  }
}

// r = m r for 1 <= m < 256, by doubling and adding from the top bit
TWW_INL void times(Fp& r, int m) {
  const Fp a = r;
  int top = 7;
  while (top > 0 && !((m >> top) & 1)) top--;
#pragma unroll 1
  for (int b = top - 1; b >= 0; b--) {
    add(r, r, r);
    if ((m >> b) & 1) add(r, r, a);
  }
}

// one phase of the tables
template <class Warp>
TWW_INL void run_phase(Warp& w, uint32_t* S, int ph) {
  const uint32_t h = phase_word(ph);
  const int n = (int)((h >> 1) & 0x7f), off = (int)(h >> 8);
  if (h & 1) {
    w.phase([&](int t) {
      if (t >= n) return;
      const uint8_t* d = record(off + t);
      const uint8_t* s = d + 8;
      Fp x, y;
      gather(x, S, s, d[2], d[3]);
      gather(y, S, s + d[2] + d[3], d[4], d[5]);
      mul(x, x, y);
      st(S, d[0], x);
    });
  } else {
    w.phase([&](int t) {
      if (t >= n) return;
      const uint8_t* d = record(off + t);
      Fp r;
      gather(r, S, d + 8, d[2], d[3]);
      times(r, d[1]);
      st(S, d[0], r);
    });
  }
}

}  // namespace ml

// The load phase: slot t < ml::kQ + 6 (P's three coordinates, then Q's
// six) from coord(t, x), then the zero slot and f = 1.
template <class Warp, class Coord>
TWW_INL void miller_load(Warp& w, uint32_t* S, Coord&& coord) {
  // slot t < 9: P and Q loaded; 9: zero; 10: f's 1; 11 .. 21: f's zeros
  w.phase([&](int t) {
    if (t >= ml::kLoaded) return;
    Fp x;
    if (t < ml::kZero) {
      coord(t, x);
    } else {
      Fp one;
      tw::consts::one(one.w);
#pragma unroll
      for (int i = 0; i < kW; i++) x.w[i] = 0;
      sel(x, t == ml::kF, one, x);
    }
    st(S, t, x);
  });
}

// The Miller program over the loaded slots of S: the set-up, per bit of
// |x| after the leading one a doubling step and on a set bit an addition
// step (one loop over the phases, so each phase kind's code exists once).
// f_{|x|,Q}(P) ends in slots ml::kF .. ml::kF + 11, not yet conjugated.
template <class Warp>
TWW_INL void miller_slots(Warp& w, uint32_t* S) {
  int ph = ml::kSetup, end = ml::kDoubling;
  int bit = 62;
  bool add_next = false;
#pragma unroll 1
  for (;;) {
    if (ph == end) {
      if (add_next) {
        ph = ml::kAddition;
        end = ml::kEnd;
        add_next = false;
      } else if (bit >= 0) {
        add_next = (tw::kXAbs >> bit) & 1;
        ph = add_next ? ml::kDoublingThenAddition : ml::kDoubling;
        end = add_next ? ml::kAddition : ml::kDoublingThenAddition;
        bit--;
      } else {
        break;
      }
    }
    ml::run_phase(w, S, ph++);
  }
}

// conj(f_{|x|,Q}(P)) of one lane, P = (xp, yp, zp) (32,) and Q = (xq, yq,
// zq) (2, 32) limbs homogeneous projective, as (2, 3, 2, 32) canonical
// limbs, by the warp `w` over the ml::kSlotWords-word buffer S: the load
// phase, the program, then f conjugated out.
template <class Warp>
TWW_INL void miller_proj_warp(Warp& w, uint32_t* S, const int32_t* xp, const int32_t* yp,
                              const int32_t* zp, const int32_t* xq, const int32_t* yq,
                              const int32_t* zq, int32_t* out) {
  miller_load(w, S, [&](int t, Fp& x) {
    const int k = t - ml::kQ;
    const int32_t* src = t == 0 ? xp : t == 1 ? yp : t == 2 ? zp
                         : (k < 2 ? xq : k < 4 ? yq : zq) + fpm::kLimbs * (k & 1);
    load_limbs(x, src);
  });
  miller_slots(w, S);
  w.phase([&](int t) {
    if (t >= 12) return;
    Fp x;
    ld(x, S, ml::kF + t);
    if (t >= 6) neg(x, x);  // x < 0
    fpm::unpack(out + fpm::kLimbs * t, x.w);
  });
}

// K3's Miller lanes: the load phase of (pk, H(m)) (`g1` false) or of (-g1,
// sig) (`g1` true, xp and yp unused), P = (xp, yp, 1) and Q = (xq, yq, 1)
// in Montgomery form; at unit Z the projective loop is the affine one.
template <class Warp>
TWW_INL void pairing_load(Warp& w, uint32_t* S, bool g1, const int32_t* xp, const int32_t* yp,
                          const int32_t* xq, const int32_t* yq) {
  miller_load(w, S, [&](int t, Fp& x) {
    const int k = t - ml::kQ;
    Fp c;
#pragma unroll
    for (int i = 0; i < kW; i++) c.w[i] = 0;
    if (t == 0 && g1) {
      tw::consts::g1_x(c.w);
    } else if (t == 1 && g1) {
      tw::consts::g1_neg_y(c.w);
    } else if (t == 2 || k == 4) {
      tw::consts::one(c.w);
    } else if (t < 2 || k < 4) {
      load_limbs(c, t == 0 ? xp : t == 1 ? yp : (k < 2 ? xq : yq) + fpm::kLimbs * (k & 1));
    }
    x = c;  // k == 5: Zq's zero imaginary part
  });
}

// K3's tail on a set's two Miller regions, f_1 in the first (S) and f_2 in
// the second (S + ml::kSlotWords), both as miller_slots leaves them: the
// product f_1 f_2 into the first region's slots kF, conjugated (x < 0:
// conj(f_1) conj(f_2) = conj(f_1 f_2)), then the final exponentiation
// there (its kSlots slots lie inside the first region) and the result out
// as (2, 3, 2, 32) canonical limbs.
template <class Warp>
TWW_INL void pairing_tail(Warp& w, uint32_t* S, int32_t* out) {
  static_assert(kSlots <= ml::kSlots, "the final exponentiation fits a Miller region");
  fp12_mul(w, S, kF, ml::kF, ml::kSlots + ml::kF);
  copy12(w, S, kF, kF, true);
  final_exp_slots(w, S);
  store12(w, S, kC, out);
}

}  // namespace tww
