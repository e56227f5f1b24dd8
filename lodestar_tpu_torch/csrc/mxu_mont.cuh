// K4's arithmetic: the Montgomery multiply REDC(a*b) as three contractions
// of 8-bit parts on the integer tensor cores, shared by the CUDA kernel
// (mxu_mont.cu) and the host harness (mxu_mont_host.cpp) that the CPU tests
// build with a C++ compiler.
//
// The function is the one of lodestar_tpu/ops/pallas_mxu.py::_mxu_kernel,
// for a warp tile of 16 products (the M of mma.m16n8k32) instead of a
// (TILE, 32) VMEM block:
//
//   t_cols = S-contraction of the outer products a_i*b_j   (3 parts of 8 bits)
//   m      = (t mod R) * N' mod R   Toeplitz(N') on 2 parts of t's limbs
//   u_cols = m * p                  Toeplitz(p)  on 2 parts of m's limbs
//   out    = carry(t_cols + u_cols), limbs 32..63
//
// with S[(i, j), c] = [c == i + j]. Every MMA input is a byte (the parts of
// the 24-bit outer products; lo = x & 0xFF and hi = x >> 8 <= 15 of the
// 12-bit limbs), so u8 x u8 products accumulate exactly in s32. Per column
// at most 32 terms meet: part sums <= 32*255, lo*lo <= 32*255^2; the
// recombinations lo + mid*256 + hi*65536 (JAX's order) are the column
// values sum a_i*b_j, sum t_i*N'_j and sum m_i*p_j, each < 32*4095^2 < 2^29,
// so t_cols + u_cols < 2^30 in int32. The carries are serial per product
// (exact on non-negative columns), which gives the same canonical limbs as
// the JAX kernel's log-depth carries. The result (T + m*p)/R does not depend
// on how m is computed, so it is limb for limb K1's (fp_mont.cuh) and the
// word-serial REDC's.
//
// One code path, two executions. Every per-lane value is an array over
// `L` lanes: L = 1 in the kernel (the thread is its lane; the MMA is the
// warp-wide mma.sync), L = 32 on the host (one thread walks the warp's
// lanes in turn between the warp syncs, and `mma` emulates the instruction
// on the fragment registers in the layout of the PTX ISA's "Matrix
// Fragments for mma.m16n8k32" for .u8). So the CPU tests check the fragment
// fills, the recombinations and the carries; only the instruction itself
// is left to the card.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define MXU_HD __host__ __device__ __forceinline__
#else
#define MXU_HD inline
#endif

namespace mxu {

constexpr int kLimbs = 32;    // 12-bit limbs per element
constexpr int kRows = 16;     // products per warp tile: the MMA's M
constexpr int kPadA = kLimbs + 1;      // shared row of a or b, padded
constexpr int kPadC = 2 * kLimbs + 1;  // shared row of 64 columns, padded

// Shared memory of one warp tile (8,384 B). `w` holds a and b while the
// outer products are contracted, then the carried limbs of t, m and the
// result; `t` keeps t's columns to the final sum.
struct Scratch {
  int32_t t[kRows * kPadC];
  int32_t w[2 * kRows * kPadA];
};
static_assert(2 * kPadA >= kPadC, "w must hold a row of 64 columns");

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

// The B fragment of S for k-step i (rows k = j, the outer products a_i*b_j)
// and n-tile nt (columns c = 8*nt + g): 1 where c == i + k.
MXU_HD void s_frag(int lane, int i, int nt, uint32_t (&b)[2]) {
  const int d = 8 * nt + (lane >> 2) - i - 4 * (lane & 3);
  b[0] = (d >= 0 && d < 4) ? 1u << (8 * d) : 0u;
  b[1] = (d >= 16 && d < 20) ? 1u << (8 * (d - 16)) : 0u;
}

// The B fragment of a constant matrix given transposed (tab[c*32 + k] is
// M[k][c], u8), for the n-tile whose first column is col0.
MXU_HD void const_frag(const uint8_t* tab, int lane, int col0, uint32_t (&b)[2]) {
  const uint8_t* row = tab + (col0 + (lane >> 2)) * kLimbs + 4 * (lane & 3);
#ifdef __CUDA_ARCH__
  b[0] = __ldg(reinterpret_cast<const uint32_t*>(row));
  b[1] = __ldg(reinterpret_cast<const uint32_t*>(row + 16));
#else
  memcpy(&b[0], row, 4);
  memcpy(&b[1], row + 16, 4);
#endif
}

// A fragments of the lo (x & 0xFF) and hi (x >> 8) parts of 12-bit limbs
// 0..31 held in shared rows of stride kPadC.
MXU_HD void limb_frags(const int32_t* w, int lane, uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; r++) {
    const int32_t* x = w + (g + 8 * (r & 1)) * kPadC + 4 * q + 16 * (r >> 1);
    uint32_t l = 0, h = 0;
#pragma unroll
    for (int e = 0; e < 4; e++) {
      l |= (uint32_t)(x[e] & 0xFF) << (8 * e);
      h |= (uint32_t)(x[e] >> 8) << (8 * e);
    }
    lo[r] = l;
    hi[r] = h;
  }
}

// Exact carry of k non-negative columns (each < 2^31) into 12-bit limbs;
// the carry out of the top column is dropped (the value mod 2^(12k)).
// MXU_SEE_COLUMN(v) sees every column carried: nothing in the kernel; the
// host build defines it to keep the largest column.
#ifndef MXU_SEE_COLUMN
#define MXU_SEE_COLUMN(v)
#endif
MXU_HD void carry_row(const int32_t* cols, int32_t* limbs, int k) {
  int64_t c = 0;
  for (int i = 0; i < k; i++) {
    MXU_SEE_COLUMN(cols[i]);
    c += cols[i];
    limbs[i] = (int32_t)(c & 0xFFF);
    c >>= 12;
  }
}

// One warp tile: out[r] = REDC(a[r] * b[r]) for the `rows` (1..16)
// contiguous (32,) limb rows at a, b, out; tnt (64 x 32) and tpt (128 x 32)
// are Toeplitz(N') and Toeplitz(p) transposed, as u8.
template <int L>
MXU_HD void tile(const int32_t* a, const int32_t* b, int32_t* out, int rows,
                 const uint8_t* tnt, const uint8_t* tpt, Scratch& s) {
  int32_t* sa = s.w;
  int32_t* sb = s.w + kRows * kPadA;

  // stage the operands (zero rows past the end), coalesced
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
    for (int w = lane; w < kRows * kLimbs; w += 32) {
      const int r = w / kLimbs, k = w % kLimbs;
      sa[r * kPadA + k] = r < rows ? a[w] : 0;
      sb[r * kPadA + k] = r < rows ? b[w] : 0;
    }
  }
  warp_sync<L>();

  // 1. t_cols: per k-step i (the outer products a_i*b_j, j = 0..31), three
  // byte parts against S, on the n-tiles that columns i..i+31 touch
  int32_t bv[L][4][4];
  int32_t acc[3][8][L][4];
#pragma unroll
  for (int part = 0; part < 3; part++)
#pragma unroll
    for (int nt = 0; nt < 8; nt++)
      for (int l = 0; l < L; l++)
#pragma unroll
        for (int x = 0; x < 4; x++) acc[part][nt][l][x] = 0;
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l), g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; r++)
#pragma unroll
      for (int e = 0; e < 4; e++)
        bv[l][r][e] = sb[(g + 8 * (r & 1)) * kPadA + 4 * q + 16 * (r >> 1) + e];
  }
  for (int i = 0; i < kLimbs; i++) {
    uint32_t parts[3][L][4];
    for (int l = 0; l < L; l++) {
      const int lane = lane_of<L>(l), g = lane >> 2;
      const int32_t ai[2] = {sa[g * kPadA + i], sa[(g + 8) * kPadA + i]};
#pragma unroll
      for (int r = 0; r < 4; r++) {
        uint32_t p0 = 0, p1 = 0, p2 = 0;
#pragma unroll
        for (int e = 0; e < 4; e++) {
          const uint32_t x = (uint32_t)(ai[r & 1] * bv[l][r][e]);  // < 2^24
          p0 |= (x & 0xFF) << (8 * e);
          p1 |= ((x >> 8) & 0xFF) << (8 * e);
          p2 |= (x >> 16) << (8 * e);
        }
        parts[0][l][r] = p0;
        parts[1][l][r] = p1;
        parts[2][l][r] = p2;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; nt++) {
      if (8 * nt + 7 < i || 8 * nt > i + kLimbs - 1) continue;  // all-zero tile of S
      uint32_t sf[L][2];
      for (int l = 0; l < L; l++) s_frag(lane_of<L>(l), i, nt, sf[l]);
#pragma unroll
      for (int part = 0; part < 3; part++) mma<L>(acc[part][nt], parts[part], sf);
    }
  }
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l), g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 8; nt++)
#pragma unroll
      for (int x = 0; x < 4; x++)
        s.t[(g + 8 * (x >> 1)) * kPadC + 8 * nt + 2 * q + (x & 1)] =
            acc[0][nt][l][x] + acc[1][nt][l][x] * 256 + acc[2][nt][l][x] * 65536;
  }
  warp_sync<L>();  // t's columns are written, and every lane is done with a, b
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
    if (lane < kRows)
      carry_row(s.t + lane * kPadC, s.w + lane * kPadC, 2 * kLimbs);
  }
  warp_sync<L>();

  // 2. m = (t mod R) * N' mod R: the parts of t's low limbs against
  // Toeplitz(N') [lo | hi]; m's columns go to w[32..63] of each row
  {
    uint32_t lo[L][4], hi[L][4];
    for (int l = 0; l < L; l++) limb_frags(s.w, lane_of<L>(l), lo[l], hi[l]);
#pragma unroll
    for (int nt = 0; nt < 4; nt++) {
      int32_t ll[L][4] = {}, lh[L][4] = {}, hl[L][4] = {}, hh[L][4] = {};
      uint32_t f_lo[L][2], f_hi[L][2];
      for (int l = 0; l < L; l++) {
        const_frag(tnt, lane_of<L>(l), 8 * nt, f_lo[l]);
        const_frag(tnt, lane_of<L>(l), kLimbs + 8 * nt, f_hi[l]);
      }
      mma<L>(ll, lo, f_lo);
      mma<L>(lh, lo, f_hi);
      mma<L>(hl, hi, f_lo);
      mma<L>(hh, hi, f_hi);
      for (int l = 0; l < L; l++) {
        const int lane = lane_of<L>(l), g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int x = 0; x < 4; x++)
          s.w[(g + 8 * (x >> 1)) * kPadC + kLimbs + 8 * nt + 2 * q + (x & 1)] =
              ll[l][x] + (lh[l][x] + hl[l][x]) * 256 + hh[l][x] * 65536;
      }
    }
  }
  warp_sync<L>();
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
    if (lane < kRows)
      carry_row(s.w + lane * kPadC + kLimbs, s.w + lane * kPadC, kLimbs);
  }
  warp_sync<L>();

  // 3. u = m * p: the parts of m's limbs against Toeplitz(p) [lo | hi],
  // added into t's columns
  {
    uint32_t lo[L][4], hi[L][4];
    for (int l = 0; l < L; l++) limb_frags(s.w, lane_of<L>(l), lo[l], hi[l]);
#pragma unroll
    for (int nt = 0; nt < 8; nt++) {
      int32_t ll[L][4] = {}, lh[L][4] = {}, hl[L][4] = {}, hh[L][4] = {};
      uint32_t f_lo[L][2], f_hi[L][2];
      for (int l = 0; l < L; l++) {
        const_frag(tpt, lane_of<L>(l), 8 * nt, f_lo[l]);
        const_frag(tpt, lane_of<L>(l), 2 * kLimbs + 8 * nt, f_hi[l]);
      }
      mma<L>(ll, lo, f_lo);
      mma<L>(lh, lo, f_hi);
      mma<L>(hl, hi, f_lo);
      mma<L>(hh, hi, f_hi);
      for (int l = 0; l < L; l++) {
        const int lane = lane_of<L>(l), g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int x = 0; x < 4; x++)
          s.t[(g + 8 * (x >> 1)) * kPadC + 8 * nt + 2 * q + (x & 1)] +=
              ll[l][x] + (lh[l][x] + hl[l][x]) * 256 + hh[l][x] * 65536;
      }
    }
  }
  warp_sync<L>();

  // 4. (t + m*p) / R: carry the sum, keep limbs 32..63
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
    if (lane < kRows)
      carry_row(s.t + lane * kPadC, s.w + lane * kPadC, 2 * kLimbs);
  }
  warp_sync<L>();
  for (int l = 0; l < L; l++) {
    const int lane = lane_of<L>(l);
    for (int w = lane; w < rows * kLimbs; w += 32)
      out[w] = s.w[(w / kLimbs) * kPadC + kLimbs + w % kLimbs];
  }
}

}  // namespace mxu
