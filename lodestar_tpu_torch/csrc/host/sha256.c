/* Portable SHA-256 with a batched two-to-one "hash level" API.
 *
 * Native-tier replacement for the reference's WASM `@chainsafe/as-sha256`
 * (SSZ merkleization hot loop — SURVEY.md §2.3): hashLevel() digests N
 * 64-byte parent preimages in one call, amortizing FFI overhead across a
 * whole merkle level. Straightforward FIPS 180-4 implementation, no
 * dependencies.
 */

#include <stdint.h>
#include <string.h>

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_compress(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  uint32_t a, b, c, d, e, f, g, h;
  int i;
  for (i = 0; i < 16; i++) {
    w[i] = ((uint32_t)block[i * 4] << 24) | ((uint32_t)block[i * 4 + 1] << 16) |
           ((uint32_t)block[i * 4 + 2] << 8) | (uint32_t)block[i * 4 + 3];
  }
  for (i = 16; i < 64; i++) {
    uint32_t s0 = ROTR(w[i - 15], 7) ^ ROTR(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ROTR(w[i - 2], 17) ^ ROTR(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  a = state[0]; b = state[1]; c = state[2]; d = state[3];
  e = state[4]; f = state[5]; g = state[6]; h = state[7];
  for (i = 0; i < 64; i++) {
    uint32_t S1 = ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

static const uint32_t IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                               0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

void lodestar_sha256(const uint8_t *data, size_t len, uint8_t out[32]) {
  uint32_t state[8];
  uint8_t block[64];
  uint64_t bitlen = (uint64_t)len * 8;
  size_t i, rem;
  memcpy(state, IV, sizeof(IV));
  for (i = 0; i + 64 <= len; i += 64) sha256_compress(state, data + i);
  rem = len - i;
  memset(block, 0, 64);
  memcpy(block, data + i, rem);
  block[rem] = 0x80;
  if (rem >= 56) {
    sha256_compress(state, block);
    memset(block, 0, 64);
  }
  for (i = 0; i < 8; i++) block[56 + i] = (uint8_t)(bitlen >> (56 - 8 * i));
  sha256_compress(state, block);
  for (i = 0; i < 8; i++) {
    out[i * 4] = (uint8_t)(state[i] >> 24);
    out[i * 4 + 1] = (uint8_t)(state[i] >> 16);
    out[i * 4 + 2] = (uint8_t)(state[i] >> 8);
    out[i * 4 + 3] = (uint8_t)state[i];
  }
}

/* N 64-byte inputs -> N 32-byte digests (one merkle level).
 * 64-byte single-block preimages take the fast fixed-padding path. */
void lodestar_sha256_level(const uint8_t *in, size_t n, uint8_t *out) {
  static const uint8_t pad_block[64] = {
      0x80, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      0,    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      0,    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      0,    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0x02, 0x00};
  size_t j;
  for (j = 0; j < n; j++) {
    uint32_t state[8];
    int i;
    memcpy(state, IV, sizeof(IV));
    sha256_compress(state, in + j * 64);
    sha256_compress(state, pad_block);
    for (i = 0; i < 8; i++) {
      uint8_t *o = out + j * 32;
      o[i * 4] = (uint8_t)(state[i] >> 24);
      o[i * 4 + 1] = (uint8_t)(state[i] >> 16);
      o[i * 4 + 2] = (uint8_t)(state[i] >> 8);
      o[i * 4 + 3] = (uint8_t)state[i];
    }
  }
}
