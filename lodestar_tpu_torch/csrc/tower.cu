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
// K3 (`pairing_warp_kernel`) replaces lodestar_tpu/ops/pallas_tower.py::_pairing_tiles,
// the Pallas TPU kernel behind individual_verify_kernel when
// LODESTAR_TPU_PALLAS_PAIRING resolves on: per signature set,
// final_exp(ML(pk, H(m)) * ML(-g1, sig)). It composes the two warp
// programs below: two warps of one block run K2p's Miller program at unit
// Z (the affine loop), one on (pk, H(m)) and one on (-g1, sig), side by
// side; after the block's barrier the set's first warp multiplies the two
// values, conjugates the product, runs K3-fe's final exponentiation on it
// and stores (miller_warp.cuh `pairing_load`, `miller_slots`,
// `pairing_tail`). The easy part inverts per set (the Euclid inverse)
// instead of sharing one batch inversion, and 0 maps to 0 as under the
// batch's zero-lane guard, so K3 equals the plain version by canonical
// value, not limb for limb. A set needs 22,020 Fp multiplies (the
// one-thread lane of tower.cuh, `pairing_lane`, shares one squaring chain
// between the two loops and runs 22,629 with Fermat's inverse); the
// schedule runs 2 x 8,182 + 54 + 10,562 in 268 + 2 + 398 dependent rounds.
// Blocks hold one or two sets (two or four warps, 4 x 7,632 B of slots at
// most; the final exponentiation's 7,200 B reuse the first Miller region),
// as many as spread the sets over the SMs.
//
// K2p (`miller_proj_warp_kernel`) is K2 in the form the batch verdicts
// call (pairing.miller_loop_proj_pq; XLA in the JAX package, lodestar_tpu/
// ops/pairing.py:225, since the Pallas kernel takes affine P and Q only):
// P and Q homogeneous projective, the tangent's l0 scaled by Zp and the
// chord through projective Q, every line scaled as the plain loop scales
// it, one lane per WARP over miller_warp.cuh (below).
//
// K2 alone is one thread per lane, over tower.cuh (fully reduced
// 12 x 32-bit words, CIOS multiply), which tower_host.cpp also builds for
// the CPU tests and as the warp kernels' oracles. One K2 lane runs 8,282
// Fp multiplies (counted by the host build), each about 576 32-bit integer
// operations, against 2.3 KB in and out per lane: the byte bound is two
// orders of magnitude below the operation bound. Its tower functions are
// real calls (__noinline__), so the working set lives on the stack, and
// `ensure_stack` raises the device-wide stack limit before the launch.
// That leaves most of the card idle and serialises every lane's
// multiplies on one thread's latency.
//
// K2p, K3-fe and K3 run one lane per warp (blocks sized from the device's
// SM count), the lane's values in shared memory, every step split into
// phases in which each thread does at most one register-resident Fp
// multiply: nothing on their path is a call (no stack, no `ensure_stack`,
// nothing in local memory), so their launchers set no device limit and
// can be captured in a CUDA graph.
// - K2p: a lane's 63 doubling and 5 addition steps need 8,182 Fp multiplies
//   (the one-thread lane of tower.cuh runs 8,493), under 0.1 us of the
//   card's int32 rate, but as a chain: f is squared and multiplied by the
//   line at every step. The schedule (miller_sched.cuh, generated by
//   gen_miller_sched.py) packs them into 268 dependent rounds of at most
//   32 products: per doubling the Fp12 squaring's 36 products, the line's
//   second level beside its last 4, the sparse line product's 39 with the
//   next step's first level of line products; 539 phases in all, run by
//   one loop over tables, so each phase kind is code once.
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
//   schedulers. A limb-parallel multiply (K1's half-warp per product,
//   fp_mont_group.cuh, is one) would shorten the round. The integer
//   tensor cores (`wgmma`) have no use here: a round is a few dozen
//   independent 384-bit products, not a matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tower.cuh"
#include "miller_warp.cuh"
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

constexpr int kMaxWarps = 4;  // the most warps (lanes) per K2p or K3-fe block

__global__ void __launch_bounds__(32 * kMaxWarps)
final_exp_warp_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t slots[kMaxWarps][tww::kSlotWords];
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // the whole warp: nothing below waits on another warp
  DeviceWarp w{(int)(threadIdx.x & 31)};
  tww::final_exp_warp(w, slots[warp], in + 384 * i, out + 384 * i);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
miller_proj_warp_kernel(const int32_t* __restrict__ xp, const int32_t* __restrict__ yp,
                        const int32_t* __restrict__ zp, const int32_t* __restrict__ xq,
                        const int32_t* __restrict__ yq, const int32_t* __restrict__ zq,
                        int32_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t slots[kMaxWarps][tww::ml::kSlotWords];
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // the whole warp: nothing below waits on another warp
  DeviceWarp w{(int)(threadIdx.x & 31)};
  tww::miller_proj_warp(w, slots[warp], xp + 32 * i, yp + 32 * i, zp + 32 * i, xq + 64 * i,
                        yq + 64 * i, zq + 64 * i, out + 384 * i);
}

constexpr int kMaxSets = 2;  // the most sets per K3 block: two warps each

// K3: per set, two warps of one block run the Miller program side by side
// at unit Z, one on (pk, H(m)) and one on (-g1, sig), each over its own
// region of ml::kSlots slots; after the block's barrier the set's first
// warp multiplies the two values (reading the second region), conjugates,
// runs the final exponentiation inside its own region and stores. A block
// holds blockDim.x / 64 sets; every warp reaches the barrier, so a set
// past n skips its work, not the barrier.
__global__ void __launch_bounds__(64 * kMaxSets)
pairing_warp_kernel(const int32_t* __restrict__ pk_x, const int32_t* __restrict__ pk_y,
                    const int32_t* __restrict__ msg_x, const int32_t* __restrict__ msg_y,
                    const int32_t* __restrict__ sig_x, const int32_t* __restrict__ sig_y,
                    int32_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t slots[2 * kMaxSets][tww::ml::kSlotWords];
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * (blockDim.x >> 6) + (warp >> 1);
  const bool second = warp & 1;
  DeviceWarp w{(int)(threadIdx.x & 31)};
  if (i < n) {
    tww::pairing_load(w, slots[warp], second, pk_x + 32 * i, pk_y + 32 * i,
                      (second ? sig_x : msg_x) + 64 * i, (second ? sig_y : msg_y) + 64 * i);
    tww::miller_slots(w, slots[warp]);
  }
  __syncthreads();
  if (i < n && !second) tww::pairing_tail(w, slots[warp], out + 384 * i);
}

// K2's tower functions are calls, so each thread needs a stack
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

// Blocks of as many lanes (`threads_per_lane` threads each) as spread n
// lanes over the device's SMs, at most `max_lanes`: (blocks, threads per
// block).
int lane_grid(long long n, int max_lanes, int threads_per_lane, unsigned& blocks,
              unsigned& threads) {
  int sms = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  long long lanes = (n + sms - 1) / sms;
  if (lanes > max_lanes) lanes = max_lanes;
  blocks = (unsigned)((n + lanes - 1) / lanes);
  threads = threads_per_lane * (unsigned)lanes;
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
// (n, 2, 3, 2, 32) canonical limbs, on `stream`. Two warps per set; blocks
// of one or two sets, as many as spread the sets over the device's SMs.
// Sets no device limit. Returns the CUDA error of the launch (0 on
// success).
extern "C" int lodestar_pairing(const int32_t* pk_x, const int32_t* pk_y,
                                const int32_t* msg_x, const int32_t* msg_y,
                                const int32_t* sig_x, const int32_t* sig_y, int32_t* out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = 0, threads = 0;
  const int rc = lane_grid(n, kMaxSets, 64, blocks, threads);
  if (rc != 0) return rc;
  pairing_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pk_x, pk_y, msg_x, msg_y,
                                                                    sig_x, sig_y, out, n);
  return (int)cudaGetLastError();
}

// K2p: out[i] = conj(f_{|x|,Q_i}(P_i)) for n lanes of projective P (32,)
// xp, yp, zp and Q (2, 32) xq, yq, zq int32 limbs; out (n, 2, 3, 2, 32)
// canonical limbs, on `stream`. One warp per lane. Returns the CUDA error
// of the launch.
extern "C" int lodestar_miller_proj(const int32_t* xp, const int32_t* yp, const int32_t* zp,
                                    const int32_t* xq, const int32_t* yq, const int32_t* zq,
                                    int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = 0, threads = 0;
  const int rc = lane_grid(n, kMaxWarps, 32, blocks, threads);
  if (rc != 0) return rc;
  miller_proj_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(xp, yp, zp, xq, yq,
                                                                        zq, out, n);
  return (int)cudaGetLastError();
}

// K3-fe: out[i] = the final exponentiation of in[i] for n (2, 3, 2, 32)
// int32 limb lanes; canonical limbs out, on `stream`. One warp per lane;
// blocks of as many warps as spread the lanes over the device's SMs, at
// most 4. Returns the CUDA error of the launch.
extern "C" int lodestar_final_exp(const int32_t* in, int32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = 0, threads = 0;
  const int rc = lane_grid(n, kMaxWarps, 32, blocks, threads);
  if (rc != 0) return rc;
  final_exp_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
