// K4: the Montgomery field multiply on Hopper's integer tensor cores (sm_90a).
//
// Replaces lodestar_tpu/ops/pallas_mxu.py::_mxu_kernel (launched by
// _mxu_tiles), the Pallas TPU kernel behind fp.mul when
// LODESTAR_TPU_PALLAS_MXU=1 and a call has at least MIN_LANES = 4096
// products: REDC(a*b) in [0, 2p) for a, b < 2p on 32 x 12-bit int32 limbs,
// as three constant-matrix contractions of 8-bit parts and three carries.
// The arithmetic lives in mxu_mont.cuh, which mxu_mont_host.cpp also builds
// for the CPU tests; the result is limb for limb K1's (mont_mul.cu).
//
// What bounds it on this card: bytes, 384 B moved per product
// (chip_smoke.py::k4_bound). REDC(a*b) needs three 32 x 32 limb-product
// contractions (a*b, t*N', m*p), 12,288 u8 multiply-adds per product as
// byte parts, a ninth of the byte time at 1,979 int8 TOP/s and 3.35 TB/s.
// The TPU formulation that this kernel follows costs far more: contracted
// densely, as the Pallas kernel does, S alone is 196,608 multiply-adds per
// product (208,896 with the Toeplitz products), nearly all by zero; with
// S's all-zero n-tiles skipped, this kernel issues 132,096.
//
// Design: one warp per 16 products (the M of mma.sync.m16n8k32.u8.u8.s32),
// four warps per block, each with 8,384 B of shared memory; no block-level
// synchronisation. a and b are staged in shared memory with coalesced
// loads. Each lane builds its A fragments of the outer products a_i*b_j
// (k-step i, three byte parts) in registers from its b_j, held for the
// whole loop, and the broadcast a_i; the B fragment of the 0/1 matrix S is
// generated from the index rule c == i + j, and the all-zero n-tiles of S
// are skipped (4 or 5 of 8 per k-step run). Toeplitz(N') and Toeplitz(p)
// come transposed from device memory (6 KB, read through the read-only
// cache). The three carries are serial, one lane per product.
//
// What the simple design leaves on the table: mma.sync, not the
// asynchronous warpgroup wgmma that reaches the tensor cores' full rate;
// the A fragments are rebuilt by integer multiplies and byte packing on
// the CUDA cores for every k-step;
// the serial carries keep half the warp idle for 160 column steps; no
// TMA, no pipelining of loads against compute. And S is a 0/1 matrix with
// one nonzero per row: skipping its all-zero n-tiles still runs 4 or 5
// tiles of 8 columns per k-step where one column per row is needed, so
// the tensor cores do 11 times the multiply-adds the function needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_mont.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
mxu_mont_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const uint8_t* __restrict__ tnt, const uint8_t* __restrict__ tpt,
                int32_t* __restrict__ out, long long n) {
  __shared__ mxu::Scratch scratch[kWarps];
  const int warp = threadIdx.x / 32;
  const long long first = ((long long)blockIdx.x * kWarps + warp) * mxu::kRows;
  if (first >= n) return;  // the whole warp leaves together
  const int rows = (int)(n - first < mxu::kRows ? n - first : mxu::kRows);
  const long long base = first * mxu::kLimbs;
  mxu::tile<1>(a + base, b + base, out + base, rows, tnt, tpt, scratch[warp]);
}

}  // namespace

// out[i] = REDC(a[i] * b[i]) for n contiguous (n, 32) int32 elements, on
// `stream`; tnt (64 x 32) and tpt (128 x 32) u8 are Toeplitz(N') and
// Toeplitz(p) transposed, 4-byte aligned. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int lodestar_mxu_mont(const int32_t* a, const int32_t* b,
                                 const uint8_t* tnt, const uint8_t* tpt,
                                 int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + mxu::kRows - 1) / mxu::kRows;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  mxu_mont_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, tnt, tpt, out, n);
  return (int)cudaGetLastError();
}
