// K4: the Montgomery field multiply with its constant products on Hopper's
// integer tensor cores (sm_90a).
//
// Replaces lodestar_tpu/ops/pallas_mxu.py::_mxu_kernel (launched by
// _mxu_tiles), the Pallas TPU kernel behind fp.mul when
// LODESTAR_TPU_PALLAS_MXU=1 and a call has at least MIN_LANES = 4096
// products: REDC(a*b) in [0, 2p) for a, b < 2p on 32 x 12-bit int32 limbs.
// The arithmetic lives in mxu_mont.cuh, which mxu_mont_host.cpp also builds
// for the CPU tests; the result is limb for limb K1's (mont_mul.cu).
//
// What bounds it on this card: bytes, 384 B moved per product
// (chip_smoke.py::k4_bound). The tensor cores do 6,656 u8 multiply-adds per
// product (mxu_mont.cuh), a seventeenth of the byte time at 1,979 int8
// TOP/s and 3.35 TB/s. What comes nearer the byte time is the CUDA-core
// work of each product's lane: the 144 word products of a*b, packing and
// unpacking 12-bit limbs, and two folds of column pairs into words, some
// 1,500 integer instructions per product.
//
// Design: a warp tile is 32 products, one per lane for the CUDA-core work
// and two m16 rows of the MMA (mma.sync.m16n8k32.u8.u8.s32; 26 MMAs per 16
// products, too few for wgmma's 64-row tiles to pay back their setup).
// a and b arrive by cp.async, 16 bytes a lane, coalesced, in 9,216 B of
// shared memory per warp, which later holds the MMA's A rows and column
// pairs, then out's rows for coalesced 16-byte stores; every shared access
// is free of bank conflicts. The Toeplitz B fragments (9,216 B, laid out
// by ops/cuda_mxu.py) are copied to shared memory once per block, in
// flight with the warps' first tiles, one 8-byte read per lane and MMA
// after. The next tile's loads are issued as soon as a tile is stored.
// Launch:
// below 4 * SMs warp tiles (the main path's 4096 products are 128) one
// warp per block, one tile each, so every tile starts at once on its own
// SM; above, four warps per block and as many blocks as fit on the card,
// each warp walking tiles (grid-stride).
//
// What this design leaves: a warp's next loads wait for its tile to be
// stored (a second staging buffer would overlap them; the resident warps
// of an SM overlap each other instead); and at small sizes one tile's
// latency, since a product's chain of dependent word operations stays on
// one lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_mont.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(32 * W)
mxu_mont_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const uint32_t* __restrict__ frags_in, int32_t* __restrict__ out, long long n) {
  __shared__ mxu::Frags frags;
  __shared__ mxu::Scratch scratch[W];
  const int warp = threadIdx.x / 32;
  const long long tiles = (n + mxu::kTile - 1) / mxu::kTile, stride = (long long)gridDim.x * W;
  long long t = (long long)blockIdx.x * W + warp;
  // the warp's first tile and the block's fragments in flight together
  if (t < tiles)
    mxu::load_tile<1>(a + t * mxu::kTile * mxu::kLimbs, b + t * mxu::kTile * mxu::kLimbs,
                      (int)(n - t * mxu::kTile < mxu::kTile ? n - t * mxu::kTile : mxu::kTile),
                      scratch[warp]);
  for (int i = threadIdx.x; i < (int)(sizeof(mxu::Frags) / 16); i += 32 * W)
    mxu::copy16(reinterpret_cast<uint4*>(&frags) + i, reinterpret_cast<const uint4*>(frags_in) + i,
                true);
  mxu::copy_wait();
  __syncthreads();
  for (; t < tiles; t += stride) {
    const long long first = t * mxu::kTile;
    mxu::tile<1>(out + first * mxu::kLimbs,
                 (int)(n - first < mxu::kTile ? n - first : mxu::kTile), frags, scratch[warp]);
    const long long next = first + stride * mxu::kTile;
    if (next < n) {
      mxu::load_tile<1>(a + next * mxu::kLimbs, b + next * mxu::kLimbs,
                        (int)(n - next < mxu::kTile ? n - next : mxu::kTile), scratch[warp]);
      mxu::copy_wait();
    }
  }
}

constexpr int kMaxDevices = 64;

// SMs and resident four-warp blocks per SM of the current device, read once
struct Shape {
  int sms = 0, blocks4 = 0;
};

int shape_of(Shape& s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static Shape cache[kMaxDevices];
  if (dev < kMaxDevices && cache[dev].sms > 0) {
    s = cache[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks4, mxu_mont_kernel<4>, 128, 0);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) cache[dev] = s;
  return 0;
}

}  // namespace

// out[i] = REDC(a[i] * b[i]) for n contiguous (n, 32) int32 elements, on
// `stream`; a, b, out and frags (the Toeplitz B fragments as mxu::Frags
// lays them out, 9,216 B) 16-byte aligned. Returns the CUDA error of the
// launch (0 on success).
extern "C" int lodestar_mxu_mont(const int32_t* a, const int32_t* b, const uint32_t* frags,
                                 int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  Shape s;
  const int rc = shape_of(s);
  if (rc != 0) return rc;
  const long long tiles = (n + mxu::kTile - 1) / mxu::kTile;
  if (tiles < 4LL * s.sms) {
    mxu_mont_kernel<1><<<(unsigned)tiles, 32, 0, (cudaStream_t)stream>>>(a, b, frags, out, n);
  } else {
    const long long need = (tiles + 3) / 4, fit = (long long)s.sms * s.blocks4;
    mxu_mont_kernel<4><<<(unsigned)(need < fit ? need : fit), 128, 0, (cudaStream_t)stream>>>(
        a, b, frags, out, n);
  }
  return (int)cudaGetLastError();
}
