/* Snappy block-format codec (compress + uncompress).
 *
 * Native replacement for the reference's `snappyjs` /
 * `@chainsafe/snappy-stream` payload codec (gossip messages, SSZ-snappy
 * req/resp framing — SURVEY.md §2.3). Implements the snappy block format
 * from the public format description: varint32 uncompressed length, then
 * literal (tag%4==0) and copy (1/2/4-byte offset) elements. The encoder
 * uses the standard greedy hash-table matcher; any valid snappy stream is
 * acceptable to peers, ratio is best-effort.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- varint ---- */

static size_t put_varint32(uint8_t *dst, uint32_t v) {
  size_t n = 0;
  while (v >= 0x80) {
    dst[n++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  dst[n++] = (uint8_t)v;
  return n;
}

static int get_varint32(const uint8_t *src, size_t len, uint32_t *out,
                        size_t *consumed) {
  uint32_t v = 0;
  int shift = 0;
  size_t i = 0;
  while (i < len && shift <= 28) {
    uint8_t b = src[i++];
    v |= (uint32_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      *consumed = i;
      return 0;
    }
    shift += 7;
  }
  return -1;
}

/* ---- emit helpers ---- */

static size_t emit_literal(uint8_t *dst, const uint8_t *src, uint32_t len) {
  size_t n = 0;
  uint32_t l = len - 1;
  if (l < 60) {
    dst[n++] = (uint8_t)(l << 2);
  } else if (l < 256) {
    dst[n++] = (uint8_t)(60 << 2);
    dst[n++] = (uint8_t)l;
  } else if (l < 65536) {
    dst[n++] = (uint8_t)(61 << 2);
    dst[n++] = (uint8_t)l;
    dst[n++] = (uint8_t)(l >> 8);
  } else if (l < (1u << 24)) {
    dst[n++] = (uint8_t)(62 << 2);
    dst[n++] = (uint8_t)l;
    dst[n++] = (uint8_t)(l >> 8);
    dst[n++] = (uint8_t)(l >> 16);
  } else {
    dst[n++] = (uint8_t)(63 << 2);
    dst[n++] = (uint8_t)l;
    dst[n++] = (uint8_t)(l >> 8);
    dst[n++] = (uint8_t)(l >> 16);
    dst[n++] = (uint8_t)(l >> 24);
  }
  memcpy(dst + n, src, len);
  return n + len;
}

/* copy of length [4..64] with offset < 65536 */
static size_t emit_copy_upto64(uint8_t *dst, uint32_t offset, uint32_t len) {
  if (len >= 4 && len <= 11 && offset < 2048) {
    dst[0] = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    dst[1] = (uint8_t)offset;
    return 2;
  }
  dst[0] = (uint8_t)(2 | ((len - 1) << 2));
  dst[1] = (uint8_t)offset;
  dst[2] = (uint8_t)(offset >> 8);
  return 3;
}

static size_t emit_copy(uint8_t *dst, uint32_t offset, uint32_t len) {
  size_t n = 0;
  while (len >= 68) {
    n += emit_copy_upto64(dst + n, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    n += emit_copy_upto64(dst + n, offset, 60);
    len -= 60;
  }
  n += emit_copy_upto64(dst + n, offset, len);
  return n;
}

/* ---- compression ---- */

#define HASH_BITS 14
#define HASH_SIZE (1 << HASH_BITS)

static uint32_t hash4(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return (v * 0x1e35a7bdu) >> (32 - HASH_BITS);
}

size_t lodestar_snappy_max_compressed(size_t n) {
  return 32 + n + n / 6;
}

/* Returns compressed size, or 0 on error. dst must hold
 * lodestar_snappy_max_compressed(len). */
size_t lodestar_snappy_compress(const uint8_t *src, size_t len, uint8_t *dst) {
  size_t dn = 0;
  uint32_t *table;
  size_t ip = 0, anchor = 0;

  dn += put_varint32(dst, (uint32_t)len);
  if (len == 0) return dn;
  if (len < 16) {
    dn += emit_literal(dst + dn, src, (uint32_t)len);
    return dn;
  }

  /* absolute candidate positions, 0xffffffff = empty */
  table = (uint32_t *)malloc(HASH_SIZE * sizeof(uint32_t));
  if (!table) return 0;
  memset(table, 0xff, HASH_SIZE * sizeof(uint32_t));

  while (ip + 4 <= len) {
    uint32_t h = hash4(src + ip);
    size_t cand = table[h];
    table[h] = (uint32_t)ip;
    if (cand != 0xffffffffu && ip - cand <= 0xffff &&
        memcmp(src + cand, src + ip, 4) == 0) {
      size_t match_len = 4;
      while (ip + match_len < len &&
             src[cand + match_len] == src[ip + match_len])
        match_len++;
      if (ip > anchor)
        dn += emit_literal(dst + dn, src + anchor, (uint32_t)(ip - anchor));
      dn += emit_copy(dst + dn, (uint32_t)(ip - cand), (uint32_t)match_len);
      ip += match_len;
      anchor = ip;
    } else {
      ip++;
    }
  }
  if (anchor < len)
    dn += emit_literal(dst + dn, src + anchor, (uint32_t)(len - anchor));
  free(table);
  return dn;
}

/* ---- decompression ---- */

/* Returns 0 on success; out_len must equal the stream's declared size. */
int lodestar_snappy_uncompress(const uint8_t *src, size_t src_len,
                               uint8_t *dst, size_t dst_len) {
  uint32_t declared;
  size_t consumed, ip, op = 0;
  if (get_varint32(src, src_len, &declared, &consumed) != 0) return -1;
  if ((size_t)declared != dst_len) return -2;
  ip = consumed;
  while (ip < src_len) {
    uint8_t tag = src[ip++];
    uint32_t kind = tag & 3;
    if (kind == 0) { /* literal */
      uint32_t l = tag >> 2;
      if (l >= 60) {
        uint32_t nbytes = l - 59, v = 0, i;
        if (ip + nbytes > src_len) return -3;
        for (i = 0; i < nbytes; i++) v |= (uint32_t)src[ip + i] << (8 * i);
        ip += nbytes;
        l = v;
      }
      l += 1;
      if (ip + l > src_len || op + l > dst_len) return -4;
      memcpy(dst + op, src + ip, l);
      ip += l;
      op += l;
    } else {
      uint32_t l, offset;
      if (kind == 1) {
        if (ip >= src_len) return -5;
        l = 4 + ((tag >> 2) & 0x7);
        offset = ((uint32_t)(tag >> 5) << 8) | src[ip++];
      } else if (kind == 2) {
        if (ip + 2 > src_len) return -5;
        l = (tag >> 2) + 1;
        offset = (uint32_t)src[ip] | ((uint32_t)src[ip + 1] << 8);
        ip += 2;
      } else {
        if (ip + 4 > src_len) return -5;
        l = (tag >> 2) + 1;
        offset = (uint32_t)src[ip] | ((uint32_t)src[ip + 1] << 8) |
                 ((uint32_t)src[ip + 2] << 16) | ((uint32_t)src[ip + 3] << 24);
        ip += 4;
      }
      if (offset == 0 || offset > op || op + l > dst_len) return -6;
      /* overlapping copies are byte-serial by definition */
      while (l--) {
        dst[op] = dst[op - offset];
        op++;
      }
    }
  }
  return op == dst_len ? 0 : -7;
}
