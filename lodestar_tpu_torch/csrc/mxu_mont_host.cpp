// Host build of K4's arithmetic (mxu_mont.cuh) with a plain C interface: the
// warp tile runs with its 32 lanes walked in turn and the MMA emulated on
// the fragment registers, so that the CPU tests hold the kernel's code path
// (fragment fills, recombinations, carries) against the plain PyTorch
// version without a GPU. Build:
//   c++ -O2 -std=c++17 -shared -fPIC -o libmxu_mont_host.so mxu_mont_host.cpp
#include <stdint.h>

// the largest column that any carry of the current call has seen
static int32_t g_col_max;
#define MXU_SEE_COLUMN(v) (g_col_max = (v) > g_col_max ? (v) : g_col_max)

#include "mxu_mont.cuh"

// out[i] = REDC(a[i] * b[i]) for n (n, 32) int32 elements; tnt, tpt as for
// the kernel. *col_max receives the largest t, m or t + u column of the
// call (the exactness bound: below 2^30).
extern "C" void lodestar_mxu_mont_host(const int32_t* a, const int32_t* b,
                                       const uint8_t* tnt, const uint8_t* tpt,
                                       int32_t* out, long long n, int32_t* col_max) {
  mxu::Scratch s;
  g_col_max = 0;
  for (long long first = 0; first < n; first += mxu::kRows) {
    const int rows = (int)(n - first < mxu::kRows ? n - first : mxu::kRows);
    mxu::tile<32>(a + 32 * first, b + 32 * first, out + 32 * first, rows, tnt, tpt, s);
  }
  *col_max = g_col_max;
}
