// Host build of the tower kernels' arithmetic (tower.cuh, tower_warp.cuh,
// miller_warp.cuh) with a plain C interface, so that the CPU tests hold the
// exact code of K2, K2p, K3 and K3-fe against the plain PyTorch versions
// without a GPU, and so that the operation bound of the kernels can be
// counted: this build alone defines TOWER_COUNT_MULS. The warps of K2p,
// K3-fe and K3 are emulated: each phase runs its 32 threads one after the
// other, in either order. The one-thread lanes of tower.cuh
// (`tw::miller_proj_lane`, `final_exp_lane`, `pairing_lane`) are kept here
// as the warp kernels' oracles.
// Build:
//   c++ -O2 -std=c++17 -shared -fPIC -o libtower_host.so tower_host.cpp
#include <stdint.h>

#define TOWER_COUNT_MULS
unsigned long long tw_fp_muls = 0;

#include "tower.cuh"
#include "miller_warp.cuh"
#include "tower_warp.cuh"

// over the warp-emulated lanes since the last reset: phases, rounds (the
// most multiplies one thread did in a phase, summed over the phases) and
// phases in which a thread multiplied more than once
unsigned long long tw_warp_phases = 0, tw_warp_rounds = 0, tw_warp_overfull = 0;

namespace {

// the warp of K2p and K3-fe on the host: phase f runs for tid 0..31, or 31..0
struct HostWarp {
  bool reverse;
  template <class F>
  void phase(F&& f) {
    unsigned long long most = 0;
    for (int k = 0; k < 32; k++) {
      const unsigned long long before = tw_fp_muls;
      f(reverse ? 31 - k : k);
      const unsigned long long muls = tw_fp_muls - before;
      if (muls > most) most = muls;
    }
    tw_warp_phases++;
    tw_warp_rounds += most;
    if (most > 1) tw_warp_overfull++;
  }
};

}  // namespace

// K2 on the host: n lanes of (32,) xp, yp and (2, 32) xq, yq limbs ->
// (n, 2, 3, 2, 32) canonical limbs.
extern "C" void lodestar_miller_host(const int32_t* xp, const int32_t* yp,
                                     const int32_t* xq, const int32_t* yq,
                                     int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    tw::miller_lane(xp + 32 * i, yp + 32 * i, xq + 64 * i, yq + 64 * i,
                    out + 384 * i);
}

// K2p's one-thread oracle on the host: n lanes of projective P (32,) xp, yp, zp and Q (2, 32)
// xq, yq, zq limbs -> (n, 2, 3, 2, 32) canonical limbs.
extern "C" void lodestar_miller_proj_host(const int32_t* xp, const int32_t* yp,
                                          const int32_t* zp, const int32_t* xq,
                                          const int32_t* yq, const int32_t* zq,
                                          int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    tw::miller_proj_lane(xp + 32 * i, yp + 32 * i, zp + 32 * i, xq + 64 * i,
                         yq + 64 * i, zq + 64 * i, out + 384 * i);
}

// K2p on the host, the warp emulated in thread order 0..31 (reverse = 0)
// or 31..0: n lanes of projective P (32,) xp, yp, zp and Q (2, 32) xq, yq,
// zq limbs -> (n, 2, 3, 2, 32) canonical limbs. The slot buffer starts
// filled with a pattern that depends on the order, so a read of a slot
// before it is written shows as a difference between the orders.
extern "C" void lodestar_miller_proj_warp_host(const int32_t* xp, const int32_t* yp,
                                               const int32_t* zp, const int32_t* xq,
                                               const int32_t* yq, const int32_t* zq,
                                               int32_t* out, long long n, int reverse) {
  uint32_t slots[tww::ml::kSlotWords];
  for (long long i = 0; i < n; i++) {
    for (int k = 0; k < tww::ml::kSlotWords; k++) slots[k] = reverse ? 0xffffffffu : 0x5a5a5a5au;
    HostWarp w{reverse != 0};
    tww::miller_proj_warp(w, slots, xp + 32 * i, yp + 32 * i, zp + 32 * i, xq + 64 * i,
                          yq + 64 * i, zq + 64 * i, out + 384 * i);
  }
}

// K3 on the host: n sets -> (n, 2, 3, 2, 32) final-exponentiated limbs.
extern "C" void lodestar_pairing_host(const int32_t* pk_x, const int32_t* pk_y,
                                      const int32_t* msg_x, const int32_t* msg_y,
                                      const int32_t* sig_x, const int32_t* sig_y,
                                      int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    tw::pairing_lane(pk_x + 32 * i, pk_y + 32 * i, msg_x + 64 * i,
                     msg_y + 64 * i, sig_x + 64 * i, sig_y + 64 * i,
                     out + 384 * i);
}

// K3 on the host, as pairing_warp_kernel runs it: per set, the two Miller
// warps (pk, H(m)) and (-g1, sig) over two adjacent slot regions, then the
// tail on the first, every warp emulated in thread order 0..31 (reverse =
// 0) or 31..0; with `reverse` the second Miller warp also runs before the
// first. The slot buffer starts filled with a pattern that depends on the
// order, so a read of a slot before it is written shows as a difference
// between the orders. n sets -> (n, 2, 3, 2, 32) canonical limbs.
extern "C" void lodestar_pairing_warp_host(const int32_t* pk_x, const int32_t* pk_y,
                                           const int32_t* msg_x, const int32_t* msg_y,
                                           const int32_t* sig_x, const int32_t* sig_y,
                                           int32_t* out, long long n, int reverse) {
  static uint32_t slots[2 * tww::ml::kSlotWords];
  for (long long i = 0; i < n; i++) {
    for (uint32_t& v : slots) v = reverse ? 0xffffffffu : 0x5a5a5a5au;
    for (int k = 0; k < 2; k++) {
      const bool second = reverse ? k == 0 : k == 1;
      HostWarp w{reverse != 0};
      uint32_t* S = slots + (second ? tww::ml::kSlotWords : 0);
      tww::pairing_load(w, S, second, pk_x + 32 * i, pk_y + 32 * i,
                        (second ? sig_x : msg_x) + 64 * i, (second ? sig_y : msg_y) + 64 * i);
      tww::miller_slots(w, S);
    }
    HostWarp w{reverse != 0};
    tww::pairing_tail(w, slots, out + 384 * i);
  }
}

// K3-fe on the host: the final exponentiation of n (2, 3, 2, 32) lanes.
extern "C" void lodestar_final_exp_host(const int32_t* in, int32_t* out,
                                        long long n) {
  for (long long i = 0; i < n; i++) tw::final_exp_lane(in + 384 * i, out + 384 * i);
}

// K3-fe on the host, the warp emulated in thread order 0..31 (reverse = 0)
// or 31..0: the final exponentiation of n (2, 3, 2, 32) lanes. The slot
// buffer starts filled with a pattern that depends on the order, so a read
// of a slot before it is written shows as a difference between the orders.
extern "C" void lodestar_final_exp_warp_host(const int32_t* in, int32_t* out,
                                             long long n, int reverse) {
  uint32_t slots[tww::kSlotWords];
  for (long long i = 0; i < n; i++) {
    for (int k = 0; k < tww::kSlotWords; k++) slots[k] = reverse ? 0xffffffffu : 0x5a5a5a5au;
    HostWarp w{reverse != 0};
    tww::final_exp_warp(w, slots, in + 384 * i, out + 384 * i);
  }
}

// n (32,) limb values -> their inverses as canonical limbs: the Euclid
// inverse of tower_warp.cuh (euclid = 1) or tower.cuh's Fermat fp_inv
extern "C" void lodestar_fp_inv_host(const int32_t* in, int32_t* out, long long n,
                                     int euclid) {
  for (long long i = 0; i < n; i++) {
    tw::Fp a, r;
    tw::load_fp(a, in + 32 * i);
    if (euclid) {
      tww::fp_inv_euclid(r, a);
    } else {
      tw::fp_inv(r, a);
    }
    tw::store_fp(out + 32 * i, r);
  }
}

// n products of (32,) limb values (reduced first) by K3-fe's FIOS multiply
// -> canonical limbs
extern "C" void lodestar_fp_mul_host(const int32_t* a, const int32_t* b, int32_t* out,
                                     long long n) {
  for (long long i = 0; i < n; i++) {
    tw::Fp x, y, r;
    tw::load_fp(x, a + 32 * i);
    tw::load_fp(y, b + 32 * i);
    tww::mul(r, x, y);
    tw::store_fp(out + 32 * i, r);
  }
}

// (phases, rounds, overfull phases) of the warp-emulated lanes since the
// last reset
extern "C" void lodestar_tower_warp_stats(unsigned long long* out, int reset) {
  out[0] = tw_warp_phases;
  out[1] = tw_warp_rounds;
  out[2] = tw_warp_overfull;
  if (reset) tw_warp_phases = tw_warp_rounds = tw_warp_overfull = 0;
}

// Fp multiplies since the last reset (the operation count of the bound).
extern "C" unsigned long long lodestar_tower_fp_muls(int reset) {
  const unsigned long long n = tw_fp_muls;
  if (reset) tw_fp_muls = 0;
  return n;
}
