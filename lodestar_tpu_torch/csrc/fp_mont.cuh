// Montgomery multiplication over the BLS12-381 base field, shared by the
// CUDA kernel (mont_mul.cu) and the host harness (mont_mul_host.cpp) that
// the CPU tests build with a C++ compiler.
//
// Operands arrive in the tensor layout of ops/limbs.py: 32 little-endian
// limbs of 12 bits in int32, Montgomery form with R = 2^384, values in
// [0, 2p). They are unpacked into 12 words of 32 bits, multiplied with
// CIOS (coarsely integrated operand scanning) using N0' = -p^-1 mod 2^32,
// and repacked. There is no final subtraction: the result is
// (a*b + M*p) / R with M = (-a*b*p^-1) mod R, which does not depend on
// the digit width, so it is limb for limb what the 12-bit word-serial
// REDC of ops/fp.py gives. For a, b < 2p it is < 2p, because 4p < R.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FPM_HD __host__ __device__ __forceinline__
#else
#define FPM_HD inline
#endif

namespace fpm {

constexpr int kLimbs = 32;      // 12-bit limbs per element
constexpr int kLimbBits = 12;
constexpr int kWords = 12;      // 32-bit words per element
constexpr uint32_t kN0 = 0xfffcfffdu;  // -p^-1 mod 2^32

// p as 12 little-endian 32-bit words, written as literals so that both
// compilers keep them in immediates (no table in device memory).
FPM_HD void load_p(uint32_t p[kWords]) {
  p[0] = 0xffffaaabu;
  p[1] = 0xb9feffffu;
  p[2] = 0xb153ffffu;
  p[3] = 0x1eabfffeu;
  p[4] = 0xf6b0f624u;
  p[5] = 0x6730d2a0u;
  p[6] = 0xf38512bfu;
  p[7] = 0x64774b84u;
  p[8] = 0x434bacd7u;
  p[9] = 0x4b1ba7b6u;
  p[10] = 0x397fe69au;
  p[11] = 0x1a0111eau;
}

// 32 limbs of 12 bits (each in [0, 4096)) -> 12 words of 32 bits.
FPM_HD void pack(uint32_t w[kWords], const int32_t limb[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kWords; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; i++) {
    const uint32_t v = (uint32_t)limb[i];
    const int bit = kLimbBits * i;
    const int k = bit >> 5;
    const int off = bit & 31;
    w[k] |= v << off;
    if (off > 32 - kLimbBits) w[k + 1] |= v >> (32 - off);
  }
}

// 12 words of 32 bits -> 32 limbs of 12 bits.
FPM_HD void unpack(int32_t limb[kLimbs], const uint32_t w[kWords]) {
#pragma unroll
  for (int i = 0; i < kLimbs; i++) {
    const int bit = kLimbBits * i;
    const int k = bit >> 5;
    const int off = bit & 31;
    uint32_t v = w[k] >> off;
    if (off > 32 - kLimbBits) v |= w[k + 1] << (32 - off);
    limb[i] = (int32_t)(v & ((1u << kLimbBits) - 1));
  }
}

// r = a*b*2^-384 mod p, lazily in [0, 2p), by CIOS on 32-bit words with
// 64-bit products. t holds kWords + 2 words; each inner step's sum
// t + x*y + carry is at most 2^64 - 1.
FPM_HD void mont_mul_words(uint32_t r[kWords], const uint32_t a[kWords],
                           const uint32_t b[kWords]) {
  uint32_t p[kWords];
  load_p(p);
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; j++) {
      const uint64_t s = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * kN0;
    s = (uint64_t)t[0] + (uint64_t)m * p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; j++) {
      s = (uint64_t)t[j] + (uint64_t)m * p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < kWords; j++) r[j] = t[j];
}

// The whole product on the tensor layout: limbs in, limbs out.
FPM_HD void mont_mul_limbs(int32_t out[kLimbs], const int32_t a[kLimbs],
                           const int32_t b[kLimbs]) {
  uint32_t aw[kWords], bw[kWords], rw[kWords];
  pack(aw, a);
  pack(bw, b);
  mont_mul_words(rw, aw, bw);
  unpack(out, rw);
}

}  // namespace fpm
