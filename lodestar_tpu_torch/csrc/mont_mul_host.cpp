// Host build of the K1 arithmetic with a plain C interface, so that the CPU
// tests can hold the kernel's exact code path against the plain PyTorch
// version without a GPU: fp_mont.cuh's one-thread CIOS (the oracle) and
// fp_mont_group.cuh's half-warp product, which is what K1 runs. The group's
// 16 lanes run as fibers (ucontext) on one host thread: each lane runs the
// kernel's code until its next exchange, publishes its value and yields;
// once every lane has published, each resumes in turn and reads the
// others' values. The lanes resume in order 0..15 or 15..0 and publish
// into one of two buffers by the parity of the exchange, so a lane never
// reads a value of the wrong exchange in either order. Build:
//   c++ -O2 -std=c++17 -shared -fPIC -o libmont_mul_host.so mont_mul_host.cpp
#include <stdint.h>
#include <ucontext.h>

#include "fp_mont.cuh"
#include "fp_mont_group.cuh"

extern "C" void lodestar_mont_mul_host(const int32_t* a, const int32_t* b,
                                       int32_t* out, long long n) {
  for (long long i = 0; i < n; i++)
    fpm::mont_mul_limbs(out + 32 * i, a + 32 * i, b + 32 * i);
}

namespace {

constexpr int kLanes = fpg::kLanes;
constexpr int kStack = 64 * 1024;

// one product's group: the fibers, their stacks and the exchange buffers
struct Fibers {
  ucontext_t main, ctx[kLanes];
  char stack[kLanes][kStack];
  uint32_t buf[2][kLanes];
  long long exchanges[kLanes];
  bool done[kLanes];
  const int32_t *a, *b;
  int32_t* out;
  bool active;
};

thread_local Fibers* current = nullptr;

// the group of fp_mont_group.cuh on the host, as seen by lane j
struct HostGroup {
  Fibers* f;
  int j;
  int parity = 0;

  int lane() const { return j; }
  // publish v, wait until every lane has, and return that exchange's values
  const uint32_t* exchange(uint32_t v) {
    uint32_t* b = f->buf[parity];
    b[j] = v;
    parity ^= 1;
    f->exchanges[j]++;
    swapcontext(&f->ctx[j], &f->main);
    return b;
  }
  uint32_t shfl(uint32_t v, int src) { return exchange(v)[src & (kLanes - 1)]; }
  uint32_t shfl_down(uint32_t v, int d) {
    const uint32_t* b = exchange(v);
    return j + d < kLanes ? b[j + d] : v;
  }
  uint32_t shfl_up(uint32_t v, int d) {
    const uint32_t* b = exchange(v);
    return j >= d ? b[j - d] : v;
  }
  uint32_t ballot(bool pred) {
    const uint32_t* b = exchange(pred ? 1u : 0u);
    uint32_t m = 0;
    for (int k = 0; k < kLanes; k++) m |= b[k] << k;
    return m;
  }
};

void lane_entry(int j) {
  Fibers* f = current;
  HostGroup g{f, j};
  fpg::mont_mul_group(g, f->a, f->b, f->out, f->active);
  f->done[j] = true;
}

// Run one product's group; returns its exchanges per lane, or -1 if the
// lanes did not make the same number of exchanges.
long long run_group(Fibers* f, bool reverse) {
  current = f;
  for (int j = 0; j < kLanes; j++) {
    getcontext(&f->ctx[j]);
    f->ctx[j].uc_stack.ss_sp = f->stack[j];
    f->ctx[j].uc_stack.ss_size = kStack;
    f->ctx[j].uc_link = &f->main;
    makecontext(&f->ctx[j], (void (*)())lane_entry, 1, j);
    f->done[j] = false;
    f->exchanges[j] = 0;
  }
  for (int finished = 0; finished == 0;) {
    for (int k = 0; k < kLanes; k++) {
      const int j = reverse ? kLanes - 1 - k : k;
      swapcontext(&f->main, &f->ctx[j]);
      finished += f->done[j];
    }
    if (finished != 0 && finished != kLanes) return -1;
  }
  for (int j = 1; j < kLanes; j++)
    if (f->exchanges[j] != f->exchanges[0]) return -1;
  return f->exchanges[0];
}

}  // namespace

// K1's half-warp product on the host: out[i] = REDC(a[i] b[i]) for n
// (32,) limb rows, the group of each product emulated with its lanes
// resumed in order 0..15 (reverse = 0) or 15..0. The products run in
// blocks of fpg::kProductsPerBlock as on the card, the tail groups of the
// last block without a product (they must read and write nothing).
// Returns the exchanges per lane of one product, or -1 if a group's lanes
// diverged.
extern "C" long long lodestar_mont_mul_group_host(const int32_t* a, const int32_t* b,
                                                  int32_t* out, long long n, int reverse) {
  Fibers* f = new Fibers;
  const long long groups =
      (n + fpg::kProductsPerBlock - 1) / fpg::kProductsPerBlock * fpg::kProductsPerBlock;
  long long exchanges = 0;
  for (long long i = 0; i < groups && exchanges >= 0; i++) {
    f->active = i < n;
    const long long row = f->active ? 32 * i : 0;
    f->a = a + row;
    f->b = b + row;
    f->out = out + row;
    const long long e = run_group(f, reverse != 0);
    exchanges = e < 0 || (i > 0 && e != exchanges) ? -1 : e;
  }
  delete f;
  return exchanges;
}
