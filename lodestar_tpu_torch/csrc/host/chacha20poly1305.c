/* ChaCha20-Poly1305 AEAD (RFC 8439), the cipher of the network's secure
 * channel: every transport frame is sealed and opened with it, so it runs
 * in C, not Python.
 *
 *   lodestar_aead_seal(key, nonce, aad, aad_len, pt, len, out)
 *       out = ciphertext (len bytes) || tag (16 bytes)
 *   lodestar_aead_open(key, nonce, aad, aad_len, ct, ct_len, out)
 *       ct_len includes the tag; out = plaintext (ct_len - 16 bytes);
 *       returns 0, or -1 when the tag does not verify (out is zeroed)
 *
 * ChaCha20 with a 32-bit block counter and a 96-bit nonce (§2.4), the
 * one-time Poly1305 key from block 0 (§2.6), the payload from block 1,
 * and Poly1305 over aad || pad16 || ct || pad16 || le64 lengths (§2.8).
 * Poly1305 is the 64-bit form (three 44/44/42-bit limbs, 128-bit
 * products); the tag is compared in constant time.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static uint32_t ld32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

static uint64_t ld64(const uint8_t *p) {
  return (uint64_t)ld32(p) | ((uint64_t)ld32(p + 4) << 32);
}

static void st32(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

static void st64(uint8_t *p, uint64_t v) {
  st32(p, (uint32_t)v);
  st32(p + 4, (uint32_t)(v >> 32));
}

/* ---- ChaCha20 ---- */

#define ROTL(x, n) (((x) << (n)) | ((x) >> (32 - (n))))
#define QR(a, b, c, d)                                                         \
  a += b; d ^= a; d = ROTL(d, 16);                                             \
  c += d; b ^= c; b = ROTL(b, 12);                                             \
  a += b; d ^= a; d = ROTL(d, 8);                                              \
  c += d; b ^= c; b = ROTL(b, 7);

static void chacha20_block(const uint8_t key[32], uint32_t counter,
                           const uint8_t nonce[12], uint8_t out[64]) {
  uint32_t s[16], x[16];
  int i;
  s[0] = 0x61707865u;
  s[1] = 0x3320646eu;
  s[2] = 0x79622d32u;
  s[3] = 0x6b206574u;
  for (i = 0; i < 8; i++) s[4 + i] = ld32(key + 4 * i);
  s[12] = counter;
  for (i = 0; i < 3; i++) s[13 + i] = ld32(nonce + 4 * i);
  memcpy(x, s, sizeof x);
  for (i = 0; i < 10; i++) {
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
  for (i = 0; i < 16; i++) st32(out + 4 * i, x[i] + s[i]);
}

static void chacha20_xor(const uint8_t key[32], uint32_t counter,
                         const uint8_t nonce[12], const uint8_t *in,
                         size_t len, uint8_t *out) {
  uint8_t ks[64];
  size_t off, i, n;
  for (off = 0; off < len; off += 64, counter++) {
    chacha20_block(key, counter, nonce, ks);
    n = len - off < 64 ? len - off : 64;
    for (i = 0; i < n; i++) out[off + i] = in[off + i] ^ ks[i];
  }
}

/* ---- Poly1305 ---- */

typedef unsigned __int128 u128;
#define M44 0xfffffffffffULL
#define M42 0x3ffffffffffULL

typedef struct {
  uint64_t r0, r1, r2, s1, s2, h0, h1, h2, pad0, pad1;
  uint8_t buf[16];
  size_t fill;
} poly1305;

static void poly_init(poly1305 *st, const uint8_t key[32]) {
  uint64_t t0 = ld64(key), t1 = ld64(key + 8);
  st->r0 = t0 & 0xffc0fffffffULL;
  st->r1 = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
  st->r2 = (t1 >> 24) & 0x00ffffffc0fULL;
  st->s1 = st->r1 * (5 << 2);
  st->s2 = st->r2 * (5 << 2);
  st->h0 = st->h1 = st->h2 = 0;
  st->pad0 = ld64(key + 16);
  st->pad1 = ld64(key + 24);
  st->fill = 0;
}

/* one 16-byte block; hibit is 2^128 (1 << 40 in the top limb) for a full
 * block, 0 for the final block, which the caller has padded with 1, 0s */
static void poly_block(poly1305 *st, const uint8_t m[16], uint64_t hibit) {
  uint64_t t0 = ld64(m), t1 = ld64(m + 8), c;
  u128 d0, d1, d2;
  st->h0 += t0 & M44;
  st->h1 += ((t0 >> 44) | (t1 << 20)) & M44;
  st->h2 += ((t1 >> 24) & M42) | hibit;
  d0 = (u128)st->h0 * st->r0 + (u128)st->h1 * st->s2 + (u128)st->h2 * st->s1;
  d1 = (u128)st->h0 * st->r1 + (u128)st->h1 * st->r0 + (u128)st->h2 * st->s2;
  d2 = (u128)st->h0 * st->r2 + (u128)st->h1 * st->r1 + (u128)st->h2 * st->r0;
  c = (uint64_t)(d0 >> 44);
  st->h0 = (uint64_t)d0 & M44;
  d1 += c;
  c = (uint64_t)(d1 >> 44);
  st->h1 = (uint64_t)d1 & M44;
  d2 += c;
  c = (uint64_t)(d2 >> 42);
  st->h2 = (uint64_t)d2 & M42;
  st->h0 += c * 5;
  c = st->h0 >> 44;
  st->h0 &= M44;
  st->h1 += c;
}

static void poly_update(poly1305 *st, const uint8_t *m, size_t len) {
  size_t n;
  if (st->fill) {
    n = 16 - st->fill < len ? 16 - st->fill : len;
    memcpy(st->buf + st->fill, m, n);
    st->fill += n;
    m += n;
    len -= n;
    if (st->fill < 16) return;
    poly_block(st, st->buf, 1ULL << 40);
    st->fill = 0;
  }
  for (; len >= 16; m += 16, len -= 16) poly_block(st, m, 1ULL << 40);
  if (len) {
    memcpy(st->buf, m, len);
    st->fill = len;
  }
}

/* zero bytes up to the next multiple of 16 (the AEAD's pad16) */
static void poly_pad16(poly1305 *st) {
  static const uint8_t zeros[16] = {0};
  if (st->fill) poly_update(st, zeros, 16 - st->fill);
}

static void poly_finish(poly1305 *st, uint8_t tag[16]) {
  uint64_t h0, h1, h2, g0, g1, g2, c;
  if (st->fill) {
    st->buf[st->fill] = 1;
    memset(st->buf + st->fill + 1, 0, 15 - st->fill);
    poly_block(st, st->buf, 0);
  }
  h0 = st->h0;
  h1 = st->h1;
  h2 = st->h2;
  c = h1 >> 44; h1 &= M44;
  h2 += c; c = h2 >> 42; h2 &= M42;
  h0 += c * 5; c = h0 >> 44; h0 &= M44;
  h1 += c; c = h1 >> 44; h1 &= M44;
  h2 += c; c = h2 >> 42; h2 &= M42;
  h0 += c * 5; c = h0 >> 44; h0 &= M44;
  h1 += c;
  /* h - p = h + 5 - 2^130: taken when it does not go negative */
  g0 = h0 + 5; c = g0 >> 44; g0 &= M44;
  g1 = h1 + c; c = g1 >> 44; g1 &= M44;
  g2 = h2 + c - (1ULL << 42);
  c = (g2 >> 63) - 1;
  g0 &= c; g1 &= c; g2 &= c;
  c = ~c;
  h0 = (h0 & c) | g0;
  h1 = (h1 & c) | g1;
  h2 = (h2 & c) | g2;
  /* + s, mod 2^128 */
  h0 += st->pad0 & M44; c = h0 >> 44; h0 &= M44;
  h1 += (((st->pad0 >> 44) | (st->pad1 << 20)) & M44) + c; c = h1 >> 44; h1 &= M44;
  h2 += ((st->pad1 >> 24) & M42) + c; h2 &= M42;
  st64(tag, h0 | (h1 << 44));
  st64(tag + 8, (h1 >> 20) | (h2 << 24));
}

/* ---- AEAD ---- */

static void aead_tag(const uint8_t key[32], const uint8_t nonce[12],
                     const uint8_t *aad, size_t aad_len, const uint8_t *ct,
                     size_t len, uint8_t tag[16]) {
  uint8_t block0[64], lens[16];
  poly1305 st;
  chacha20_block(key, 0, nonce, block0);
  poly_init(&st, block0);
  poly_update(&st, aad, aad_len);
  poly_pad16(&st);
  poly_update(&st, ct, len);
  poly_pad16(&st);
  st64(lens, (uint64_t)aad_len);
  st64(lens + 8, (uint64_t)len);
  poly_update(&st, lens, 16);
  poly_finish(&st, tag);
  memset(block0, 0, sizeof block0);
}

int lodestar_aead_seal(const uint8_t key[32], const uint8_t nonce[12],
                       const uint8_t *aad, size_t aad_len, const uint8_t *pt,
                       size_t len, uint8_t *out) {
  chacha20_xor(key, 1, nonce, pt, len, out);
  aead_tag(key, nonce, aad, aad_len, out, len, out + len);
  return 0;
}

int lodestar_aead_open(const uint8_t key[32], const uint8_t nonce[12],
                       const uint8_t *aad, size_t aad_len, const uint8_t *ct,
                       size_t ct_len, uint8_t *out) {
  uint8_t tag[16];
  unsigned diff = 0;
  size_t len, i;
  if (ct_len < 16) return -1;
  len = ct_len - 16;
  aead_tag(key, nonce, aad, aad_len, ct, len, tag);
  for (i = 0; i < 16; i++) diff |= tag[i] ^ ct[len + i];
  if (diff) {
    memset(out, 0, len);
    return -1;
  }
  chacha20_xor(key, 1, nonce, ct, len, out);
  return 0;
}
