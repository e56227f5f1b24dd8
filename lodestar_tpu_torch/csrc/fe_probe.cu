// A probe of K3-fe's warp schedule (tower_warp.cuh) on the card: where one
// lane's cycles go, by operation. It is not on the port's path:
// `python3 -m lodestar_tpu_torch.profile_fe` builds it when asked and
// reads it.
//
// One warp runs each operation of the lane `reps` times in a row over the
// same slots, thread 0 reading the SM clock after a __syncwarp() before
// and after, then the whole lane once as the kernel runs it. Before that,
// thread 0 alone times `reps` dependent Fp multiplies (tower_warp.cuh's
// FIOS, and fp_mont.cuh's CIOS with the same final subtraction), `reps`
// dependent Fp additions and `reps` Euclid inverses: the cost of one
// round's multiply, of one addition and of the easy part's Fp inverse.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tower_warp.cuh"

namespace {

struct ProbeWarp {
  int tid;
  template <class F>
  __device__ __forceinline__ void phase(F&& f) const {
    f(tid);
    __syncwarp();
  }
};

// cycles[] in this order (profile_fe.PROBE_FIELDS)
enum : int {
  kMulFios, kMulCios, kAdd, kCyc, kMul12, kFrob, kConj, kInv, kEuclid, kLane, kKeep,
};

__device__ __forceinline__ long long stamp() {
  __syncwarp();
  return clock64();
}

__global__ void __launch_bounds__(32)
fe_probe_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                long long* __restrict__ cycles, int reps) {
  __shared__ __align__(16) uint32_t S[tww::kSlotWords];
  const int tid = threadIdx.x;
  ProbeWarp w{tid};
  if (tid == 0) {
    tw::Fp x, y, z, e;
    tww::load_limbs(x, in);
    tww::load_limbs(y, in + fpm::kLimbs);
    z = x;
    const long long t0 = clock64();
#pragma unroll 1
    for (int k = 0; k < reps; k++) tww::mul(x, x, y);
    const long long t1 = clock64();
#pragma unroll 1
    for (int k = 0; k < reps; k++) {
      uint32_t t[fpm::kWords];
      fpm::mont_mul_words(t, z.w, y.w);
      tww::reduce(z, t);
    }
    const long long t2 = clock64();
#pragma unroll 1
    for (int k = 0; k < reps; k++) tww::add(y, y, x);
    const long long t3 = clock64();
#pragma unroll 1
    for (int k = 0; k < reps; k++) {  // y, 1/y, y, ...: each inverse waits on the last
      tww::fp_inv_euclid(e, y);
      y = e;
    }
    const long long t4 = clock64();
    cycles[kMulFios] = t1 - t0;
    cycles[kMulCios] = t2 - t1;
    cycles[kAdd] = t3 - t2;
    cycles[kEuclid] = t4 - t3;
    cycles[kKeep] = (long long)(x.w[0] ^ y.w[0] ^ z.w[0] ^ e.w[0]);  // keeps every chain
  }
  // the lane's f at kF, and again at kB as a second operand
  w.phase([&](int t) {
    if (t >= 24) return;
    tw::Fp x;
    tww::load_limbs(x, in + fpm::kLimbs * (t % 12));
    tww::st(S, (t < 12 ? tww::kF : tww::kB) + t % 12, x);
  });
  long long t = stamp(), u;
#pragma unroll 1
  for (int k = 0; k < reps; k++) tww::cyclotomic_sqr(w, S, tww::kA, tww::kF);
  u = stamp();
  if (tid == 0) cycles[kCyc] = u - t;
  t = u;
#pragma unroll 1
  for (int k = 0; k < reps; k++) tww::fp12_mul(w, S, tww::kA, tww::kF, tww::kB);
  u = stamp();
  if (tid == 0) cycles[kMul12] = u - t;
  t = u;
#pragma unroll 1
  for (int k = 0; k < reps; k++) tww::frobenius(w, S, tww::kA, tww::kF, 1 + k % 2);
  u = stamp();
  if (tid == 0) cycles[kFrob] = u - t;
  t = u;
#pragma unroll 1
  for (int k = 0; k < reps; k++) tww::copy12(w, S, tww::kA, tww::kF, true);
  u = stamp();
  if (tid == 0) cycles[kConj] = u - t;
  t = u;
#pragma unroll 1
  for (int k = 0; k < reps; k++) tww::fp12_inv(w, S);  // kT = kF^-1, scratch kA, kB
  u = stamp();
  if (tid == 0) cycles[kInv] = u - t;
  t = u;
  tww::final_exp_warp(w, S, in, out);
  u = stamp();
  if (tid == 0) cycles[kLane] = u - t;
}

}  // namespace

// One lane `in` (2, 3, 2, 32) int32 limbs -> `out`, its final
// exponentiation as K3-fe computes it, and `cycles` (11 int64, in the
// order of the enum above): each operation's cycles over `reps` runs, the
// whole lane's over one. On `stream`; returns the CUDA error of the launch.
extern "C" int lodestar_fe_probe(const int32_t* in, int32_t* out, long long* cycles, int reps,
                                 void* stream) {
  if (reps <= 0) return (int)cudaErrorInvalidValue;
  fe_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(in, out, cycles, reps);
  return (int)cudaGetLastError();
}
