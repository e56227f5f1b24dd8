// K2 and K3: the affine Miller loop and the fused per-set pairing on Hopper
// (sm_90a).
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
// The arithmetic lives in tower.cuh (fully reduced 12 x 32-bit words, CIOS
// multiply), which tower_host.cpp also builds for the CPU tests.
//
// What bounds them on this card: operations. One K2 lane runs 8,282 Fp
// multiplies and one K3 set 22,629 (counted by the host build), each about
// 576 32-bit integer operations, against 768 B in and 1,536 B out per K2
// lane and 1,280 B in per K3 set: the byte bound is about two orders of
// magnitude below the operation bound.
//
// Design, and what it leaves on the table: one thread per lane, blocks of
// 32 threads so that a few hundred lanes spread over several SMs. The loop
// runs inside the thread with the Fp12 accumulator, the ladder point and
// the lines in local memory; tower functions are real calls (__noinline__),
// so the working set lives on the stack. That leaves most of the card idle
// at the path's sizes (256 lanes are 8 warps on 132 SMs), serialises every
// lane's ~8-23 k multiplies on one thread's latency, and pays local-memory
// traffic on every tower step. The redesign is a warp or a block per lane
// (coefficients of the Fp12 spread over threads) with the accumulator in
// registers or shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tower.cuh"

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

// The tower functions are calls, so each thread needs a stack as deep as
// the deepest call chain (several Fp12 values per frame). Raise the
// per-thread stack limit to what the kernel reports, never lower it.
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
