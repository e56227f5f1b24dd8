// K1: the Montgomery field multiply on Hopper (sm_90a).
//
// Replaces lodestar_tpu/ops/pallas_fp.py::_mont_mul_kernel, the Pallas TPU
// kernel behind fp.mul when LODESTAR_TPU_PALLAS_MUL=1: REDC(a*b) =
// a*b*2^-384 mod p, lazily in [0, 2p), for a, b < 2p on 32 x 12-bit int32
// limbs. The arithmetic lives in fp_mont.cuh (CIOS on 12 x 32-bit words,
// no final subtraction), so the result is limb for limb the 12-bit
// word-serial REDC of the plain version in ops/cuda_fp.py.
//
// What bounds it on this card: one product moves 384 B (two 128 B operands
// in, 128 B out), 0.115 ns at 3.35 TB/s, against 2 * 12^2 = 288 32-bit word
// products (each giving a low and a high half) plus the repacking, a few
// hundred integer instructions per thread. At the main path's shapes it is
// bounded by neither: many calls are chains over a handful of lanes (the
// Fermat inverse in final_exponentiation_one, the two power chains of
// fp2_sqrt), so the launch latency is what a call costs.
//
// Design: one thread per product. A block of 128 threads stages its 128
// operand pairs through shared memory so that global loads and stores are
// coalesced (consecutive threads touch consecutive 4 B words); rows are
// padded to 33 words so that thread t reading its own row hits bank
// (t + k) mod 32, without conflicts. The kernel launches on the caller's
// stream, allocates nothing, and is checked with cudaGetLastError by the
// C entry point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_mont.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRow = fpm::kLimbs + 1;  // padded shared-memory row

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long n) {
  __shared__ int32_t sa[kThreads * kRow];
  __shared__ int32_t sb[kThreads * kRow];
  const long long first = (long long)blockIdx.x * kThreads;
  const long long words = (n - first < kThreads ? n - first : kThreads) * fpm::kLimbs;
  const long long base = first * fpm::kLimbs;

  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int row = w / fpm::kLimbs, col = w % fpm::kLimbs;
    sa[row * kRow + col] = a[base + w];
    sb[row * kRow + col] = b[base + w];
  }
  __syncthreads();

  if (first + threadIdx.x < n) {
    int32_t x[fpm::kLimbs], y[fpm::kLimbs], r[fpm::kLimbs];
#pragma unroll
    for (int k = 0; k < fpm::kLimbs; k++) {
      x[k] = sa[threadIdx.x * kRow + k];
      y[k] = sb[threadIdx.x * kRow + k];
    }
    fpm::mont_mul_limbs(r, x, y);
#pragma unroll
    for (int k = 0; k < fpm::kLimbs; k++) sa[threadIdx.x * kRow + k] = r[k];
  }
  __syncthreads();

  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int row = w / fpm::kLimbs, col = w % fpm::kLimbs;
    out[base + w] = sa[row * kRow + col];
  }
}

}  // namespace

// out[i] = REDC(a[i] * b[i]) for n contiguous (n, 32) int32 elements, on
// `stream`. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lodestar_mont_mul(const int32_t* a, const int32_t* b,
                                 int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  mont_mul_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}
