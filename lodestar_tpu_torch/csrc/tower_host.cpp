// Host build of the tower kernels' arithmetic (tower.cuh) with a plain C
// interface, so that the CPU tests hold the exact code of K2, K2p, K3 and
// K3-fe against the plain PyTorch versions without a GPU, and so that the
// operation bound of the kernels can be counted: this build alone defines TOWER_COUNT_MULS.
// Build:
//   c++ -O2 -std=c++17 -shared -fPIC -o libtower_host.so tower_host.cpp
#include <stdint.h>

#define TOWER_COUNT_MULS
unsigned long long tw_fp_muls = 0;

#include "tower.cuh"

// K2 on the host: n lanes of (32,) xp, yp and (2, 32) xq, yq limbs ->
// (n, 2, 3, 2, 32) canonical limbs.
extern "C" void lodestar_miller_host(const int32_t* xp, const int32_t* yp,
                                     const int32_t* xq, const int32_t* yq,
                                     int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    tw::miller_lane(xp + 32 * i, yp + 32 * i, xq + 64 * i, yq + 64 * i,
                    out + 384 * i);
}

// K2p on the host: n lanes of projective P (32,) xp, yp, zp and Q (2, 32)
// xq, yq, zq limbs -> (n, 2, 3, 2, 32) canonical limbs.
extern "C" void lodestar_miller_proj_host(const int32_t* xp, const int32_t* yp,
                                          const int32_t* zp, const int32_t* xq,
                                          const int32_t* yq, const int32_t* zq,
                                          int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    tw::miller_proj_lane(xp + 32 * i, yp + 32 * i, zp + 32 * i, xq + 64 * i,
                         yq + 64 * i, zq + 64 * i, out + 384 * i);
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

// K3-fe on the host: the final exponentiation of n (2, 3, 2, 32) lanes.
extern "C" void lodestar_final_exp_host(const int32_t* in, int32_t* out,
                                        long long n) {
  for (long long i = 0; i < n; i++) tw::final_exp_lane(in + 384 * i, out + 384 * i);
}

// Fp multiplies since the last reset (the operation count of the bound).
extern "C" unsigned long long lodestar_tower_fp_muls(int reset) {
  const unsigned long long n = tw_fp_muls;
  if (reset) tw_fp_muls = 0;
  return n;
}
