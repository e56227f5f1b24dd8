// K4's arithmetic: the Montgomery multiply REDC(a*b) for a warp tile of 32
// products, one product per lane, with its two constant products on the
// integer tensor cores; shared by the CUDA kernel (mxu_mont.cu) and the
// host harness (mxu_mont_host.cpp) that the CPU tests build with a C++
// compiler.
//
// The function is the one of lodestar_tpu/ops/pallas_mxu.py::_mxu_kernel:
// out = (t + m*p) / R with t = a*b, m = (t mod R)*N' mod R, R = 2^384. The
// TPU kernel forms t's columns by contracting the outer products a_i*b_j
// with a 0/1 select matrix S, which suits a matrix unit that does nothing
// else well. Hopper's CUDA cores multiply 32-bit words, so here
//
//   t  = a*b          12 x 12 schoolbook on 32-bit words, 64-bit products,
//                     one product per lane (CUDA cores; exact, carried)
//   mc = bytes(t mod R) . Toeplitz(bytes(N'))   48 byte columns, MMA
//   m  = fold(mc) mod R                          32-bit words, one lane
//   uc = bytes(m) . Toeplitz(bytes(p))           96 byte columns, MMA
//   out = words 12..23 of fold(t + uc)           one lane, then 12-bit limbs
//
// The MMA is mma.sync.m16n8k32 .u8 x .u8 -> .s32 and its digits are the
// 48 bytes of t mod R and of m, which are the little-endian bytes of their
// 32-bit words, so an A fragment register is a word of t or m as it is.
// The depth is padded to 64 (two k32 steps) and the all-zero tiles of the
// Toeplitz matrices are skipped: 8 MMAs for m (6 n-tiles of N', two of them
// with a second k-step) and 18 for u (12 n-tiles of p) per 16 products,
// 26 * 16*8*32 / 16 = 6,656 u8 multiply-adds per product (the TPU
// formulation: 208,896 dense; this kernel's previous design: 132,096; the
// 12,288 that chip_smoke.py's bound counts for the three 12-bit-limb
// contractions is the ceiling).
//
// Exactness. A byte column sums at most 48 products of two bytes:
// <= 48 * 255^2 = 3,121,200 < 2^22, exact in s32. The owner of columns
// 2j and 2j+1 (the same lane holds both) stores x_j = c_2j + 256 c_2j+1
// < 2^30. A lane folds its product's x_j into 32-bit words with a 64-bit
// accumulator: word w takes x_2w + x_2w+1 * 2^16 (< 2^47) plus the carry,
// which the compiler emits as add.cc/addc pairs. The sum t + m*p < 2^766
// fits the 24 words, so nothing is dropped but the carry out of m's
// word 11 (mod R). The result (t + m*p)/R does not depend on the digits m
// was computed in, so it is limb for limb K1's (fp_mont.cuh) and the
// 12-bit word-serial REDC's, in [0, 2p) for a, b < 2p since 4p < R.
//
// One code path, two executions. Every per-lane value is an array over
// `L` lanes: L = 1 in the kernel (the thread is its lane; the MMA is the
// warp-wide mma.sync), L = 32 on the host (one thread walks the warp's
// lanes in turn between the warp syncs, and `mma` emulates the instruction
// on the fragment registers in the layout of the PTX ISA's "Matrix
// Fragments for mma.m16n8k32" for .u8). So the CPU tests check the
// fragment fills, the column pairs, the folds and the carries; only the
// instruction itself is left to the card.
#pragma once

#include <stdint.h>
#include <string.h>

#include "fp_mont.cuh"

#ifdef __CUDACC__
#define MXU_HD __host__ __device__ __forceinline__
#else
#define MXU_HD inline
#endif

namespace mxu {

constexpr int kLimbs = 32;   // 12-bit limbs per element
constexpr int kWords = 12;   // 32-bit words per element
constexpr int kBytes = 48;   // bytes of t mod R, m, N' and p
constexpr int kTile = 32;    // products per warp tile: one per lane, two m16 MMA tiles
constexpr int kNtM = 6;      // n-tiles of m's 48 byte columns (mod R)
constexpr int kNtU = 12;     // n-tiles of u's 96 byte columns

// Shared rows, in 32-bit words. Each stride makes the accesses that use it
// free of bank conflicts: 16-byte row reads and writes by lane (IO: 36 and
// pairs: 52, both 4 mod 8), A fragment reads by lane (g, q) at 20g + q, and
// pair writes at 52g + q (20 mod 32).
constexpr int kRowIO = kLimbs + 4;  // a, b and out as staged 12-bit limbs
constexpr int kRowA = 20;           // 16 words of bytes (12 + 4 zero) + 4
constexpr int kRowX = 52;           // 48 column pairs + 4

// Shared memory of one warp tile (9,216 B): a and b staged for coalesced
// loads (and out for coalesced stores), or the A operand rows and the
// column pairs of the two MMA steps.
union alignas(16) Scratch {
  uint32_t io[2 * kTile * kRowIO];
  struct {
    uint32_t a[kTile * kRowA];
    uint32_t x[kTile * kRowX];
  } w;
};
static_assert(sizeof(Scratch) == 2 * kTile * kRowIO * 4, "the two views share the bytes");

// The Toeplitz B fragments, staged once per block as the caller lays them
// out (ops/cuda_mxu.py::FRAGS): [2*nt + s][lane] for n-tile nt and k-step
// s, m's first (9,216 B). Lane (g, q) of fragment (nt, s) holds B rows
// 32s + 4q + 16r .. +3 of column 8nt + g in register r.
struct Frags {
  uint32_t m[2 * kNtM][32][2];
  uint32_t u[2 * kNtU][32][2];
};

// A lane's own shared row to or from registers, 16 bytes at a time (the
// strides above make these the conflict-free accesses).
template <int N>
MXU_HD void row_load(uint32_t (&dst)[N], const uint32_t* src) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < N / 4; i++) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[i];
    dst[4 * i] = v.x, dst[4 * i + 1] = v.y, dst[4 * i + 2] = v.z, dst[4 * i + 3] = v.w;
  }
#else
  memcpy(dst, src, sizeof(dst));
#endif
}

template <int N>
MXU_HD void row_store(uint32_t* dst, const uint32_t (&src)[N]) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < N / 4; i++)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
#else
  memcpy(dst, src, sizeof(src));
#endif
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid:
// cp.async on the card (no registers held; copy_wait ends the lane's
// copies), a copy on the host.
MXU_HD void copy16(void* dst, const void* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
#else
  if (valid)
    memcpy(dst, src, 16);
  else
    memset(dst, 0, 16);
#endif
}

MXU_HD void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Whether the Toeplitz n-tile nt (columns 8nt..8nt+7) has a nonzero entry
// in k-step s (rows 32s..32s+31, of which those below 48 are digits):
// column c meets row k where 0 <= c - k < 48.
MXU_HD constexpr bool tile_used(int nt, int s) {
  return 8 * nt + 7 >= 32 * s &&
         8 * nt <= (32 * s + 31 < kBytes - 1 ? 32 * s + 31 : kBytes - 1) + kBytes - 1;
}

template <int L>
MXU_HD int lane_of(int l) {
  if constexpr (L == 1) {
#ifdef __CUDA_ARCH__
    return threadIdx.x & 31;
#else
    return l;
#endif
  } else {
    return l;
  }
}

template <int L>
MXU_HD void warp_sync() {
  if constexpr (L == 1) {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
}

// D = A*B + D for the warp: A 16x32 u8 (row), B 32x8 u8 (col), D 16x8 s32.
// Lane (g = lane >> 2, q = lane & 3) holds A rows g + 8*(r & 1), columns
// 4q + 16*(r >> 1) + e in byte e of a[r]; B rows 4q + 16*r + e, column g in
// byte e of b[r]; D row g + 8*(i >> 1), column 2q + (i & 1) in d[i].
template <int L>
MXU_HD void mma(int32_t (&d)[L][4], const uint32_t (&a)[L][4], const uint32_t (&b)[L][2]) {
  if constexpr (L == 1) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
          "r"(b[0][0]), "r"(b[0][1]));
#endif
  } else {
    static_assert(L == 32, "the host emulates a whole warp");
    uint8_t A[16][32], B[32][8];
    int32_t D[16][8];
    for (int lane = 0; lane < 32; lane++) {
      const int g = lane >> 2, q = lane & 3;
      for (int r = 0; r < 4; r++)
        for (int e = 0; e < 4; e++)
          A[g + 8 * (r & 1)][4 * q + 16 * (r >> 1) + e] = (a[lane][r] >> (8 * e)) & 0xFF;
      for (int r = 0; r < 2; r++)
        for (int e = 0; e < 4; e++)
          B[4 * q + 16 * r + e][g] = (b[lane][r] >> (8 * e)) & 0xFF;
      for (int i = 0; i < 4; i++) D[g + 8 * (i >> 1)][2 * q + (i & 1)] = d[lane][i];
    }
    for (int m = 0; m < 16; m++)
      for (int n = 0; n < 8; n++) {
        int32_t s = D[m][n];
        for (int k = 0; k < 32; k++) s += (int32_t)A[m][k] * (int32_t)B[k][n];
        D[m][n] = s;
      }
    for (int lane = 0; lane < 32; lane++) {
      const int g = lane >> 2, q = lane & 3;
      for (int i = 0; i < 4; i++) d[lane][i] = D[g + 8 * (i >> 1)][2 * q + (i & 1)];
    }
  }
}

// t = a*b, 12 x 12 words -> 24, exact (each step's sum < 2^64).
MXU_HD void mul_wide(uint32_t t[2 * kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
#pragma unroll
  for (int j = 0; j < 2 * kWords; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; j++) {
      const uint64_t s = (uint64_t)t[i + j] + (uint64_t)a[j] * b[i] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + kWords] = (uint32_t)c;
  }
}

// MXU_SEE_COLUMN(v) sees every byte column that an MMA step gives:
// nothing in the kernel; the host build defines it to keep the largest.
#ifndef MXU_SEE_COLUMN
#define MXU_SEE_COLUMN(v)
#endif

// One MMA step for the warp tile: the byte rows in s.w.a (one per product,
// kRowA words) times the Toeplitz fragments `fr` (NT n-tiles), into the
// column pairs s.w.x (pair 4nt + q of row g holds columns 8nt + 2q and
// 8nt + 2q + 1 as c0 + 256*c1).
template <int L, int NT>
MXU_HD void mma_step(Scratch& s, const uint32_t (&fr)[2 * NT][32][2]) {
#pragma unroll
  for (int h = 0; h < 2; h++) {  // products 16h..16h+15
    uint32_t af[2][L][4];
    for (int l = 0; l < L; l++) {
      const int lane = lane_of<L>(l), g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int k = 0; k < 2; k++)
#pragma unroll
        for (int r = 0; r < 4; r++)
          af[k][l][r] = s.w.a[(16 * h + g + 8 * (r & 1)) * kRowA + 8 * k + q + 4 * (r >> 1)];
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt++) {
      int32_t d[L][4] = {};
#pragma unroll
      for (int k = 0; k < 2; k++) {
        if (!tile_used(nt, k)) continue;
        uint32_t bf[L][2];
        for (int l = 0; l < L; l++) {
          const int lane = lane_of<L>(l);
          bf[l][0] = fr[2 * nt + k][lane][0];
          bf[l][1] = fr[2 * nt + k][lane][1];
        }
        mma<L>(d, af[k], bf);
      }
      for (int l = 0; l < L; l++) {
        const int lane = lane_of<L>(l), g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int i = 0; i < 4; i++) MXU_SEE_COLUMN(d[l][i]);
        s.w.x[(16 * h + g) * kRowX + 4 * nt + q] = (uint32_t)(d[l][0] + 256 * d[l][1]);
        s.w.x[(16 * h + g + 8) * kRowX + 4 * nt + q] = (uint32_t)(d[l][2] + 256 * d[l][3]);
      }
    }
  }
}

// Start a warp tile: stage the `rows` (1..32) contiguous (32,) limb rows at
// a and b (16-byte aligned) in s.io, 16 bytes a lane and copy, zero rows
// past the end. The copies land by the lane's copy_wait.
template <int L>
MXU_HD void load_tile(const int32_t* a, const int32_t* b, int rows, Scratch& s) {
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
#pragma unroll
    for (int j = 0; j < kTile * kLimbs / 4 / 32; j++) {
      const int i = lane + 32 * j, r = i >> 3, k = 4 * (i & 7);
      const bool valid = r < rows;
      copy16(s.io + r * kRowIO + k, valid ? a + 4 * i : a, valid);
      copy16(s.io + (kTile + r) * kRowIO + k, valid ? b + 4 * i : b, valid);
    }
  }
}

// Finish a warp tile started by load_tile (every lane past its copy_wait):
// out[r] = REDC(a[r] * b[r]) for its `rows` rows.
template <int L>
MXU_HD void tile(int32_t* out, int rows, const Frags& fr, Scratch& s) {
  warp_sync<L>();  // every lane's copies are visible

  // t = a*b, one product per lane
  uint32_t t[L][2 * kWords];
  for (int l = 0; l < L; l++) {
    const int p = lane_of<L>(l);
    uint32_t la[kLimbs], lb[kLimbs], aw[kWords], bw[kWords];
    row_load(la, s.io + p * kRowIO);
    row_load(lb, s.io + (kTile + p) * kRowIO);
    fpm::pack(aw, reinterpret_cast<const int32_t*>(la));
    fpm::pack(bw, reinterpret_cast<const int32_t*>(lb));
    mul_wide(t[l], aw, bw);
  }
  warp_sync<L>();  // a and b are read: their bytes become the A rows
  for (int l = 0; l < L; l++) {
    uint32_t row[kRowA];
#pragma unroll
    for (int w = 0; w < kRowA; w++) row[w] = w < kWords ? t[l][w] : 0;
    row_store(s.w.a + lane_of<L>(l) * kRowA, row);
  }
  warp_sync<L>();

  // m = (t mod R) * N' mod R: byte columns 0..47 on the tensor cores, the
  // fold on each product's lane; m's words become the A rows
  mma_step<L, kNtM>(s, fr.m);
  warp_sync<L>();
  for (int l = 0; l < L; l++) {
    const int p = lane_of<L>(l);
    uint32_t x[2 * kWords], row[kRowA];
    row_load(x, s.w.x + p * kRowX);
    uint64_t acc = 0;
#pragma unroll
    for (int w = 0; w < kWords; w++) {
      acc += (uint64_t)x[2 * w] + ((uint64_t)x[2 * w + 1] << 16);
      row[w] = (uint32_t)acc;
      acc >>= 32;
    }
#pragma unroll
    for (int w = kWords; w < kRowA; w++) row[w] = 0;
    row_store(s.w.a + p * kRowA, row);
  }
  warp_sync<L>();

  // u = m * p: byte columns 0..95; then t + u on each product's lane,
  // whose words 12..23 are the result
  mma_step<L, kNtU>(s, fr.u);
  warp_sync<L>();
  uint32_t res[L][kLimbs];
  for (int l = 0; l < L; l++) {
    uint32_t x[4 * kWords], r[kWords];
    row_load(x, s.w.x + lane_of<L>(l) * kRowX);
    uint64_t acc = 0;
#pragma unroll
    for (int w = 0; w < 2 * kWords; w++) {
      acc += (uint64_t)t[l][w] + x[2 * w] + ((uint64_t)x[2 * w + 1] << 16);
      if (w >= kWords) r[w - kWords] = (uint32_t)acc;
      acc >>= 32;
    }
    fpm::unpack(reinterpret_cast<int32_t*>(res[l]), r);
  }
  warp_sync<L>();  // the pairs are read: the rows become out's staging
  for (int l = 0; l < L; l++) row_store(s.io + lane_of<L>(l) * kRowIO, res[l]);
  warp_sync<L>();
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
#pragma unroll
    for (int j = 0; j < kTile * kLimbs / 4 / 32; j++) {
      const int i = lane + 32 * j;
      if (i >= rows * kLimbs / 4) break;
      const uint32_t* src = s.io + (i >> 3) * kRowIO + 4 * (i & 7);
#ifdef __CUDA_ARCH__
      *reinterpret_cast<uint4*>(out + 4 * i) = *reinterpret_cast<const uint4*>(src);
#else
      memcpy(out + 4 * i, src, 16);
#endif
    }
  }
  warp_sync<L>();  // out is stored: the next tile may stage over it
}

}  // namespace mxu
