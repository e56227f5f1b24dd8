// Host build of the K1 arithmetic (fp_mont.cuh) with a plain C interface,
// so that the CPU tests can hold the kernel's exact code path against the
// plain PyTorch version without a GPU. Build:
//   c++ -O2 -std=c++17 -shared -fPIC -o libmont_mul_host.so mont_mul_host.cpp
#include <stdint.h>

#include "fp_mont.cuh"

extern "C" void lodestar_mont_mul_host(const int32_t* a, const int32_t* b,
                                       int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    fpm::mont_mul_limbs(out + 32 * i, a + 32 * i, b + 32 * i);
}
