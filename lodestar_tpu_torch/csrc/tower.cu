// K2 and K3: the Miller loop and the fused per-set pairing on Hopper
// (sm_90a), each with a second entry point for the batch verdicts' main
// path (K2p, K3-fe).
//
// K2 (`miller_kernel`) replaces lodestar_tpu/ops/pallas_tower.py::_miller_tiles,
// the Pallas TPU kernel behind pairing.miller_loop when
// LODESTAR_TPU_PALLAS_MILLER resolves on (on a TPU): conj(f_{|x|,Q}(P)) for
// affine P in G1 and affine Q on the twist, 63 doubling steps plus the
// additions on the set bits of |x|.
//
// K3 (`pairing_kernel`) replaces lodestar_tpu/ops/pallas_tower.py::_pairing_tiles,
// the Pallas TPU kernel behind individual_verify_kernel when
// LODESTAR_TPU_PALLAS_PAIRING resolves on: per signature set,
// final_exp(ML(pk, H(m)) * ML(-g1, sig)). The two Miller loops share one
// squaring chain (their product is the same field element), and the easy
// part inverts per thread by Fermat instead of sharing one batch inversion
// across a tile: the final exponentiation is one field element either way,
// and 0 maps to 0 as under the batch's zero-lane guard. So K3 equals the
// plain version by canonical value, not limb for limb.
//
// K2p (`miller_proj_kernel`) is K2 in the form the batch verdicts call
// (pairing.miller_loop_proj_pq; XLA in the JAX package, lodestar_tpu/ops/
// pairing.py:225, since the Pallas kernel takes affine P and Q only): P and
// Q homogeneous projective, the tangent's l0 scaled by Zp and the chord
// through projective Q, every line scaled as the plain loop scales it.
//
// K2, K2p and K3 are one thread per lane over tower.cuh (fully reduced
// 12 x 32-bit words, CIOS multiply), which tower_host.cpp also builds for
// the CPU tests. One K2 lane runs 8,282 Fp multiplies, one K2p lane 8,493
// and one K3 set 22,629 (counted by the host build), each about 576 32-bit
// integer operations, against at most 2.8 KB in and out per lane: the byte
// bound is two orders of magnitude below the operation bound. Their tower
// functions are real calls (__noinline__), so the working set lives on the
// stack, and `ensure_stack` raises the device-wide stack limit before the
// launch. That leaves most of the card idle at the path's sizes and
// serialises every lane's multiplies on one thread's latency.
//
// K3-fe (`final_exp_warp_kernel`) is K3's tail in the main path's form:
// the final exponentiation of one Fp12 lane (pairing.final_exponentiation_batch,
// JAX lodestar_tpu/ops/pairing.py:343) per WARP, over tower_warp.cuh.
// - What bounds it: the dependent rounds, not the card's operation rate.
//   A lane needs 7,724 Fp multiplies (the schedule runs 10,562), under
//   0.1 us of the card's int32 rate, but they form a chain: 315 cyclotomic squarings and 35 Fp12 products
//   one after the other, plus the easy part's inversion. The batch
//   verdicts exponentiate one product per verdict, so there is one lane to
//   run, and its time is the rounds times the time of one round.
// - What the design does: one warp per lane (blocks of 1-4 warps), the
//   lane's Fp12 values in shared memory, every tower operation split into
//   phases in which each thread does at most one register-resident Fp
//   multiply: a cyclotomic squaring is one round of 27 products, an Fp12
//   product two rounds of 54, 398 rounds in all. Nothing on the path is a
//   call (no stack, no `ensure_stack`, nothing in local memory), and the
//   easy part's one Fp inversion is a variable-time binary extended Euclid
//   on thread 0 instead of Fermat's chain of 610 dependent
//   multiplies. It equals the batch form, which shares one inversion, by
//   canonical value.
// - What it leaves: a round is one thread's serial 12 x 12-word FIOS plus
//   the additions around it, issued by one warp on one of the SM's four
//   schedulers. A limb-parallel multiply (several threads, on several
//   warps, per product, carries exchanged through shared memory or
//   shuffles) would shorten the round. The integer tensor cores (`wgmma`)
//   have no use here: a round is a few dozen independent 384-bit products,
//   not a matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tower.cuh"
#include "tower_warp.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
miller_kernel(const int32_t* __restrict__ xp, const int32_t* __restrict__ yp,
              const int32_t* __restrict__ xq, const int32_t* __restrict__ yq,
              int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  tw::miller_lane(xp + 32 * i, yp + 32 * i, xq + 64 * i, yq + 64 * i, out + 384 * i);
}

__global__ void __launch_bounds__(kThreads)
pairing_kernel(const int32_t* __restrict__ pk_x, const int32_t* __restrict__ pk_y,
               const int32_t* __restrict__ msg_x, const int32_t* __restrict__ msg_y,
               const int32_t* __restrict__ sig_x, const int32_t* __restrict__ sig_y,
               int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  tw::pairing_lane(pk_x + 32 * i, pk_y + 32 * i, msg_x + 64 * i, msg_y + 64 * i,
                   sig_x + 64 * i, sig_y + 64 * i, out + 384 * i);
}

__global__ void __launch_bounds__(kThreads)
miller_proj_kernel(const int32_t* __restrict__ xp, const int32_t* __restrict__ yp,
                   const int32_t* __restrict__ zp, const int32_t* __restrict__ xq,
                   const int32_t* __restrict__ yq, const int32_t* __restrict__ zq,
                   int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  tw::miller_proj_lane(xp + 32 * i, yp + 32 * i, zp + 32 * i, xq + 64 * i, yq + 64 * i,
                       zq + 64 * i, out + 384 * i);
}

// The warp of tower_warp.cuh's phases on the card: every thread runs the
// phase for its lane index, then the warp synchronises, which also orders
// the phase's shared-memory writes before the next phase's reads.
struct DeviceWarp {
  int tid;
  template <class F>
  __device__ __forceinline__ void phase(F&& f) const {
    f(tid);
    __syncwarp();
  }
};

constexpr int kFeWarps = 4;  // the most warps (lanes) per K3-fe block

__global__ void __launch_bounds__(32 * kFeWarps)
final_exp_warp_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t slots[kFeWarps][tww::kSlotWords];
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // the whole warp: nothing below waits on another warp
  DeviceWarp w{(int)(threadIdx.x & 31)};
  tww::final_exp_warp(w, slots[warp], in + 384 * i, out + 384 * i);
}

// K2, K2p and K3's tower functions are calls, so each thread needs a stack
// as deep as the deepest call chain (several Fp12 values per frame). Raise
// the per-thread stack limit to what the kernel reports, never lower it.
template <typename K>
int ensure_stack(K kernel) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  size_t cur = 0;
  rc = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
  if (rc != cudaSuccess) return (int)rc;
  if (attr.localSizeBytes > cur) {
    rc = cudaDeviceSetLimit(cudaLimitStackSize, attr.localSizeBytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

constexpr int kMaxDevices = 64;

// the SMs of the current device, read once per device
int sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static int cache[kMaxDevices];
  if (dev < kMaxDevices && cache[dev] > 0) {
    sms = cache[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) cache[dev] = sms;
  return 0;
}

}  // namespace

// K2: out[i] = conj(f_{|x|,Q_i}(P_i)) for n lanes of (32,) xp, yp and
// (2, 32) xq, yq int32 limbs; out (n, 2, 3, 2, 32) canonical limbs, on
// `stream`. Returns the CUDA error of the launch (0 on success).
extern "C" int lodestar_miller(const int32_t* xp, const int32_t* yp, const int32_t* xq,
                               const int32_t* yq, int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int rc = ensure_stack(miller_kernel);
  if (rc != 0) return rc;
  miller_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(xp, yp, xq, yq, out, n);
  return (int)cudaGetLastError();
}

// K3: out[i] = final_exp(ML(pk_i, H_i) * ML(-g1, sig_i)) for n sets of
// (32,) pk_x, pk_y and (2, 32) msg_x, msg_y, sig_x, sig_y int32 limbs; out
// (n, 2, 3, 2, 32) canonical limbs, on `stream`. Returns the CUDA error of
// the launch (0 on success).
extern "C" int lodestar_pairing(const int32_t* pk_x, const int32_t* pk_y,
                                const int32_t* msg_x, const int32_t* msg_y,
                                const int32_t* sig_x, const int32_t* sig_y, int32_t* out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  const int rc = ensure_stack(pairing_kernel);
  if (rc != 0) return rc;
  pairing_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, out, n);
  return (int)cudaGetLastError();
}

// K2p: out[i] = conj(f_{|x|,Q_i}(P_i)) for n lanes of projective P (32,)
// xp, yp, zp and Q (2, 32) xq, yq, zq int32 limbs; out (n, 2, 3, 2, 32)
// canonical limbs, on `stream`. Returns the CUDA error of the launch.
extern "C" int lodestar_miller_proj(const int32_t* xp, const int32_t* yp, const int32_t* zp,
                                    const int32_t* xq, const int32_t* yq, const int32_t* zq,
                                    int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int rc = ensure_stack(miller_proj_kernel);
  if (rc != 0) return rc;
  miller_proj_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(xp, yp, zp, xq, yq,
                                                                         zq, out, n);
  return (int)cudaGetLastError();
}

// K3-fe: out[i] = the final exponentiation of in[i] for n (2, 3, 2, 32)
// int32 limb lanes; canonical limbs out, on `stream`. One warp per lane;
// blocks of as many warps as spread the lanes over the device's SMs, at
// most 4. Returns the CUDA error of the launch.
extern "C" int lodestar_final_exp(const int32_t* in, int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  int sms = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  long long warps = (n + sms - 1) / sms;
  if (warps > kFeWarps) warps = kFeWarps;
  const unsigned blocks = (unsigned)((n + warps - 1) / warps);
  final_exp_warp_kernel<<<blocks, 32 * (unsigned)warps, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
