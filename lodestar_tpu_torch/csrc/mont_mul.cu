// K1: the Montgomery field multiply on Hopper (sm_90a).
//
// Replaces lodestar_tpu/ops/pallas_fp.py::_mont_mul_kernel, the Pallas TPU
// kernel behind fp.mul when LODESTAR_TPU_PALLAS_MUL=1: REDC(a*b) =
// a*b*2^-384 mod p, lazily in [0, 2p), for a, b < 2p on 32 x 12-bit int32
// limbs. The arithmetic lives in fp_mont_group.cuh (REDC on 12 x 32-bit
// words by a group of 16 threads, no final subtraction), so the result is
// limb for limb the 12-bit word-serial REDC of the plain version in
// ops/cuda_fp.py and fp_mont.cuh's one-thread CIOS, which the host
// harness keeps as its oracle.
//
// What bounds it on this card: one product moves 384 B (two 128 B operands
// in, 128 B out), 0.115 ns at 3.35 TB/s, against 2 * 12^2 = 288 32-bit word
// products (each giving a low and a high half). At the main path's shapes
// (128 to 2,048 products per launch) it is bounded by neither: a launch
// costs the latency of one product's dependent chain plus the launch.
//
// Design: a half-warp per product, so that the chain is the 12 outer steps
// of the multiply (each two dependent shuffles and two wide multiply-adds)
// instead of one thread's 144-step CIOS, and so that 2,048 products are
// 256 blocks over every SM rather than 16 blocks of one thread per
// product. A block of 128 threads holds 8 products; lane j of a group
// loads limbs 2j and 2j + 1 of each operand straight from device memory
// (8 B per thread: a group's loads and its store are one 128 B row each,
// coalesced, no shared memory). The tail group of the last block runs its
// shuffles on zeros and skips its loads and its store, so no shuffle has
// a missing partner. The kernel launches on the caller's stream,
// allocates nothing, and is checked with cudaGetLastError by the C entry
// point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_mont_group.cuh"

namespace {

constexpr int kProducts = fpg::kProductsPerBlock;
constexpr int kThreads = kProducts * fpg::kLanes;  // 128

// The group of fp_mont_group.cuh on the card: 16 lanes of a warp's half,
// every lane of the warp present at every exchange.
struct DeviceGroup {
  __device__ __forceinline__ int lane() const { return threadIdx.x & 15; }
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, fpg::kLanes);
  }
  __device__ __forceinline__ uint32_t shfl_down(uint32_t v, int d) const {
    return __shfl_down_sync(0xffffffffu, v, d, fpg::kLanes);
  }
  __device__ __forceinline__ uint32_t shfl_up(uint32_t v, int d) const {
    return __shfl_up_sync(0xffffffffu, v, d, fpg::kLanes);
  }
  __device__ __forceinline__ uint32_t ballot(bool pred) const {
    return (__ballot_sync(0xffffffffu, pred) >> (threadIdx.x & 16)) & 0xffffu;
  }
};

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kProducts + (threadIdx.x >> 4);
  const bool active = i < n;
  const long long row = active ? fpm::kLimbs * i : 0;
  DeviceGroup g;
  fpg::mont_mul_group(g, a + row, b + row, out + row, active);
}

}  // namespace

// out[i] = REDC(a[i] * b[i]) for n contiguous (n, 32) int32 elements, on
// `stream`. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lodestar_mont_mul(const int32_t* a, const int32_t* b,
                                 int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kProducts - 1) / kProducts;
  mont_mul_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}
