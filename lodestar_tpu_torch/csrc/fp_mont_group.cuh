// Montgomery multiplication with a group of 16 threads (a half-warp) per
// product, shared by K1 (mont_mul.cu) and its host harness
// (mont_mul_host.cpp), which runs the same code with the group's shuffles
// emulated.
//
// The group is a template argument `G` that gives the thread its lane and
// the group's exchanges, with CUDA's semantics inside a group of 16:
//   g.lane()              this thread's index j in the group, 0..15
//   g.shfl(v, src)        v of lane src
//   g.shfl_down(v, d)     v of lane j + d; lanes j + d >= 16 keep their own v
//   g.shfl_up(v, d)       v of lane j - d; lanes j < d keep their own v
//   g.ballot(pred)        bit k set where lane k's pred holds (16 bits)
// Every lane calls every exchange, in the same order: a lane with no
// product (the tail of a block) runs the arithmetic on zeros and only
// skips its loads and its store.
//
// The product is the same integer as fp_mont.cuh's one-thread CIOS:
// REDC(a b) = (a b + M p) / 2^384 with M = -a b p^-1 mod 2^384, no final
// subtraction, so it is limb for limb what mont_mul_limbs and the 12-bit
// word-serial REDC of ops/fp.py give, < 2p for a, b < 2p. Only the
// carries are kept differently:
// - unpack: lane j loads limbs 2j and 2j + 1 of each operand (8 B, so a
//   group's loads are one 128 B row), a 24-bit chunk at bit 24j; word
//   w < 12 is chunk floor(4w/3) shifted down by 32w mod 24 (0, 8 or 16)
//   joined with the next chunk, two shuffles per operand;
// - lane j holds word j of the accumulator t as u_j = acc + 2^64 cw, a
//   64-bit sum and its carry word, redundant: t = sum_j u_j 2^(32j) over
//   14 words (lanes 12..15 multiply nothing: their a_j and p_j are 0);
// - each of the 12 outer steps i: every lane adds a_j b_i (b_i shuffled
//   from lane i); m = t_0 N0' mod 2^32 from lane 0's low word, shuffled to
//   the group (t mod 2^32 is lo(u_0): every other word is a multiple of
//   2^32); every lane adds m p_j, which zeroes lo(u_0); the group shifts
//   down one word, u_j <- lo(u_{j+1}) + hi(u_j), hi(u_j) = floor(u_j / 2^32)
//   (lane 15 takes 0 for lo(u_16));
// - headroom: after a shift u_j <= (2^32 - 1) + H, H the largest hi(u)
//   so far; a step adds two products of at most (2^32 - 1)^2 < 2^64, so
//   u_j < 2^32 + H + 2^65 and hi(u_j) < 2^33 + 1 + H / 2^32, which is
//   below 2^34 again for H < 2^34: every u_j < 2^66, the 64-bit sum plus
//   a carry word of at most 3, and hi(u_j) < 2^34 fits the next sum (the
//   all-ones operands below 2p, 2^381 - 1, reach the largest products);
// - normalise: the last shift leaves u_j < 2^32 + 2^34, so lo(u_j) plus
//   hi(u_{j-1}) (< 8, one shuffle up) is < 2^32 + 8: a carry of at most 1
//   out of each word, which a look-ahead over two ballots resolves
//   (generate G: the word overflowed; propagate P: its low word is all
//   ones; the carries into the words are (A + G) ^ A ^ G with A = G | P,
//   the lanes as bits of one integer);
// - pack: lane j gathers bits 24j .. 24j + 23 of the words (two shuffles)
//   and stores limbs 2j and 2j + 1.
// A product is 45 exchanges, 36 of them in the outer steps.
#pragma once

#include <stdint.h>

#include "fp_mont.cuh"

namespace fpg {

constexpr int kLanes = 16;  // threads per product
constexpr int kProductsPerBlock = 8;  // K1's blocks of 128 threads

// word j of p, 0 for j >= 12
FPM_HD uint32_t p_word(int j) {
  uint32_t p[fpm::kWords];
  fpm::load_p(p);
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < fpm::kWords; k++) r = k == j ? p[k] : r;
  return r;
}

// acc + 2^64 cw += x
FPM_HD void add_wide(uint64_t& acc, uint32_t& cw, uint64_t x) {
  acc += x;
  cw += acc < x ? 1u : 0u;
}

// Word j (< 12) of a value whose lane k holds its 24-bit chunk at bit 24k;
// 0 on lanes 12..15.
template <class G>
FPM_HD uint32_t chunks_to_word(G& g, uint32_t chunk) {
  const int j = g.lane();
  const int ja = (4 * j) / 3, off = 32 * j - 24 * ja;  // off: 0, 8 or 16
  const uint32_t lo = g.shfl(chunk, ja & (kLanes - 1));
  const uint32_t hi = g.shfl(chunk, (ja + 1) & (kLanes - 1));
  const uint32_t w = (lo >> off) | (hi << (24 - off));
  return j < fpm::kWords ? w : 0u;
}

// The 24-bit chunk at bit 24j of a value whose lane k holds its word k.
template <class G>
FPM_HD uint32_t word_to_chunk(G& g, uint32_t word) {
  const int j = g.lane();
  const int k = (3 * j) >> 2, off = (24 * j) & 31;  // off: 0, 24, 16 or 8
  const uint32_t lo = g.shfl(word, k);
  const uint32_t hi = g.shfl(word, k + 1);
  const uint32_t c = (lo >> off) | (off ? hi << (32 - off) : 0u);
  return c & 0xffffffu;
}

// out = REDC(a b) for one product of (32,) 12-bit limbs, a, b < 2p, by the
// group g; a lane with `active` false reads and writes nothing.
template <class G>
FPM_HD void mont_mul_group(G& g, const int32_t* a, const int32_t* b, int32_t* out,
                           bool active) {
  const int j = g.lane();
  uint32_t ca = 0, cb = 0;
  if (active) {
    ca = (uint32_t)a[2 * j] | (uint32_t)a[2 * j + 1] << fpm::kLimbBits;
    cb = (uint32_t)b[2 * j] | (uint32_t)b[2 * j + 1] << fpm::kLimbBits;
  }
  const uint32_t aw = chunks_to_word(g, ca);
  const uint32_t bw = chunks_to_word(g, cb);
  const uint32_t pw = p_word(j);

  uint64_t acc = 0;
  uint32_t cw = 0;
#pragma unroll
  for (int i = 0; i < fpm::kWords; i++) {
    add_wide(acc, cw, (uint64_t)aw * g.shfl(bw, i));
    const uint32_t m = g.shfl((uint32_t)acc * fpm::kN0, 0);
    add_wide(acc, cw, (uint64_t)m * pw);
    const uint32_t next = g.shfl_down((uint32_t)acc, 1);
    acc = (acc >> 32) + ((uint64_t)cw << 32) + (j + 1 < kLanes ? next : 0u);
    cw = 0;
  }

  // normalise: one carry of at most 1 out of each word, then look ahead
  const uint32_t below = g.shfl_up((uint32_t)(acc >> 32), 1);
  const uint64_t s = (acc & 0xffffffffull) + (j > 0 ? below : 0u);
  const uint32_t lo = (uint32_t)s;
  const uint32_t gen = g.ballot((s >> 32) != 0);
  const uint32_t all = gen | g.ballot(lo == 0xffffffffu);
  const uint32_t carries = ((all + gen) ^ all ^ gen) & 0xffffu;
  const uint32_t word = lo + ((carries >> j) & 1u);

  const uint32_t c = word_to_chunk(g, word);
  if (active) {
    out[2 * j] = (int32_t)(c & 0xfffu);
    out[2 * j + 1] = (int32_t)(c >> fpm::kLimbBits);
  }
}

}  // namespace fpg
