/* Native persistent KV engine — the LevelDB-class storage tier.
 *
 * The port's copy of the JAX package's `native/src/kvstore.c`, with one
 * change: the segment limit and read verification are arguments of
 * `lodestar_kv_open_with` (0 and 0 by default, as with no environment
 * there) instead of `LODESTAR_KV_SEG_LIMIT` and `LODESTAR_KV_PARANOID`.
 * The on-disk format is the same, so a datadir written by either package
 * opens in the other.
 *
 * Replaces the reference's leveldown (C++ LevelDB behind
 * db/src/controller/level.ts — SURVEY.md §2.3) with a from-scratch
 * log-structured engine in the bitcask family:
 *
 *   - values live ON DISK in append-only CRC-framed segment files;
 *     only the key index (key bytes + 16B locator per entry) stays in
 *     memory, so a datadir can exceed process memory (FileDb
 *     loads everything into a Python dict).
 *   - writes append to the active segment (fsync on batch boundaries),
 *     segments rotate at SEG_LIMIT; replay tolerates torn tails.
 *   - deletes append tombstones; compaction rewrites live records into
 *     fresh segments when the dead ratio crosses a threshold.
 *   - range iteration sorts the in-memory keys (qsort) on demand — the
 *     archive sweep / prefix-scan access pattern of the beacon DB
 *     (Repository.keys_stream) is rare next to point reads.
 *
 * Single-writer, in-process. Thread safety is the binding's job (the
 * Python layer serializes through its own lock).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#ifdef _WIN32
#error "POSIX only"
#endif
#include <dirent.h>
#include <errno.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#define KV_SEG_LIMIT (256u * 1024u * 1024u)
#define KV_MAX_SEGS 4096
#define KV_COMPACT_RATIO 2 /* dead > live * ratio -> compact */
#define KV_COMPACT_MIN (8u * 1024u * 1024u)

/* ---------------- crc32 (IEEE, table-driven) ---------------- */

static uint32_t kv_crc_table[256];
static int kv_crc_init_done = 0;

static void kv_crc_init(void) {
  if (kv_crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    kv_crc_table[i] = c;
  }
  kv_crc_init_done = 1;
}

static uint32_t kv_crc32(uint32_t crc, const uint8_t *buf, size_t len) {
  crc = ~crc;
  for (size_t i = 0; i < len; i++)
    crc = kv_crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

/* ---------------- index ---------------- */

typedef struct {
  uint64_t key_off;  /* into key arena; UINT64_MAX = empty slot */
  uint64_t val_off;  /* value offset within segment */
  uint32_t val_len;
  uint16_t key_len;
  uint16_t file_id;
} kv_slot;

typedef struct kv_store {
  char dir[3072];
  /* hash table, open addressing, power-of-two */
  kv_slot *slots;
  uint64_t cap;
  uint64_t count;
  /* key arena */
  uint8_t *arena;
  uint64_t arena_len, arena_cap;
  uint64_t arena_dead; /* bytes of arena held by overwritten keys */
  /* segments */
  int active_fd;
  uint16_t active_id;
  uint64_t active_size;
  uint64_t live_bytes, dead_bytes;
  /* one-slot read-fd cache for sealed segments (archive sweeps issue
   * thousands of gets against the same sealed file) */
  int read_fd;
  int read_fd_id;
  /* rotation threshold: KV_SEG_LIMIT, or the `seg_limit` argument of
   * lodestar_kv_open_with (test hook — lets compaction tests span
   * segments without writing 256 MB) */
  uint64_t seg_limit;
  /* verify record CRCs on get: always during compaction's copy loop
   * (corruption must not propagate into the new generation) and with
   * `verify_reads` set at open; off on the hot read path (open-time replay
   * already CRC-checks every record) */
  int verify_reads;
} kv_store;

static uint64_t kv_hash(const uint8_t *key, size_t len) {
  uint64_t h = 1469598103934665603ull; /* FNV-1a 64 */
  for (size_t i = 0; i < len; i++) {
    h ^= key[i];
    h *= 1099511628211ull;
  }
  return h;
}

static const uint8_t *kv_key_at(const kv_store *s, const kv_slot *e) {
  return s->arena + e->key_off;
}

static int kv_grow(kv_store *s);
void lodestar_kv_close(kv_store *s);

/* find slot for key; returns pointer to slot (occupied with the key, or
 * first empty). */
static kv_slot *kv_find(kv_store *s, const uint8_t *key, size_t klen) {
  uint64_t mask = s->cap - 1;
  uint64_t i = kv_hash(key, klen) & mask;
  for (;;) {
    kv_slot *e = &s->slots[i];
    if (e->key_off == UINT64_MAX) return e;
    if (e->key_len == klen && memcmp(kv_key_at(s, e), key, klen) == 0) return e;
    i = (i + 1) & mask;
  }
}

static int kv_arena_push(kv_store *s, const uint8_t *key, size_t klen,
                         uint64_t *off) {
  if (s->arena_len + klen > s->arena_cap) {
    uint64_t ncap = s->arena_cap ? s->arena_cap * 2 : 1 << 20;
    while (ncap < s->arena_len + klen) ncap *= 2;
    uint8_t *na = realloc(s->arena, ncap);
    if (!na) return -1;
    s->arena = na;
    s->arena_cap = ncap;
  }
  memcpy(s->arena + s->arena_len, key, klen);
  *off = s->arena_len;
  s->arena_len += klen;
  return 0;
}

static int kv_index_put(kv_store *s, const uint8_t *key, size_t klen,
                        uint16_t file_id, uint64_t val_off, uint32_t val_len) {
  if ((s->count + 1) * 10 >= s->cap * 7) {
    if (kv_grow(s) != 0) return -1;
  }
  kv_slot *e = kv_find(s, key, klen);
  if (e->key_off == UINT64_MAX) {
    if (kv_arena_push(s, key, klen, &e->key_off) != 0) return -1;
    e->key_len = (uint16_t)klen;
    s->count++;
  }
  e->file_id = file_id;
  e->val_off = val_off;
  e->val_len = val_len;
  return 0;
}

/* tombstone-free deletion: open addressing needs backward-shift or a
 * DELETED marker; use the marker (key_len == UINT16_MAX sentinel would
 * clash with real keys' lengths, so mark by val_len and keep the key for
 * probe continuity). */
#define KV_DELETED UINT32_MAX

static void kv_index_del(kv_store *s, const uint8_t *key, size_t klen) {
  kv_slot *e = kv_find(s, key, klen);
  if (e->key_off != UINT64_MAX && e->val_len != KV_DELETED) {
    e->val_len = KV_DELETED;
    s->arena_dead += e->key_len;
  }
}

static int kv_grow(kv_store *s) {
  uint64_t ncap = s->cap ? s->cap * 2 : 1024;
  kv_slot *ns = malloc(ncap * sizeof(kv_slot));
  if (!ns) return -1;
  for (uint64_t i = 0; i < ncap; i++) ns[i].key_off = UINT64_MAX;
  kv_slot *old = s->slots;
  uint64_t ocap = s->cap;
  s->slots = ns;
  s->cap = ncap;
  uint64_t live = 0;
  for (uint64_t i = 0; i < ocap; i++) {
    kv_slot *e = &old[i];
    if (e->key_off == UINT64_MAX || e->val_len == KV_DELETED) continue;
    kv_slot *n = kv_find(s, kv_key_at(s, e), e->key_len);
    *n = *e;
    live++;
  }
  s->count = live;
  free(old);
  return 0;
}

/* ---------------- segments ---------------- */

static void kv_seg_path(const kv_store *s, uint16_t id, char *out,
                        size_t outlen) {
  snprintf(out, outlen, "%s/seg-%05u.kv", s->dir, (unsigned)id);
}

/* record: [crc32 u32][op u8][klen u16][vlen u32][key][value] (LE) */
#define KV_HDR 11

static int kv_append_record(kv_store *s, uint8_t op, const uint8_t *key,
                            uint16_t klen, const uint8_t *val, uint32_t vlen,
                            uint64_t *val_off_out) {
  uint8_t hdr[KV_HDR];
  hdr[4] = op;
  memcpy(hdr + 5, &klen, 2);
  memcpy(hdr + 7, &vlen, 4);
  uint32_t crc = kv_crc32(0, hdr + 4, KV_HDR - 4);
  crc = kv_crc32(crc, key, klen);
  if (vlen) crc = kv_crc32(crc, val, vlen);
  memcpy(hdr, &crc, 4);
  uint64_t rec_off = s->active_size;
  if (write(s->active_fd, hdr, KV_HDR) != KV_HDR) return -1;
  if (write(s->active_fd, key, klen) != (ssize_t)klen) return -1;
  if (vlen && write(s->active_fd, val, vlen) != (ssize_t)vlen) return -1;
  if (val_off_out) *val_off_out = rec_off + KV_HDR + klen;
  s->active_size += KV_HDR + klen + vlen;
  return 0;
}

static int kv_open_active(kv_store *s, uint16_t id, int truncate) {
  char path[3200];
  kv_seg_path(s, id, path, sizeof(path));
  /* O_RDWR: gets are pread()s against the same fd when the key lives in
   * the active segment; O_APPEND keeps every write at the tail. */
  int fd = open(path, O_CREAT | O_RDWR | (truncate ? O_TRUNC : O_APPEND),
                0644);
  if (fd < 0) return -1;
  if (s->active_fd >= 0) close(s->active_fd);
  s->active_fd = fd;
  s->active_id = id;
  struct stat st;
  s->active_size = (fstat(fd, &st) == 0) ? (uint64_t)st.st_size : 0;
  return 0;
}

static int kv_maybe_rotate(kv_store *s) {
  if (s->active_size < (s->seg_limit ? s->seg_limit : KV_SEG_LIMIT)) return 0;
  if (s->active_id + 1 >= KV_MAX_SEGS) return 0; /* refuse to wrap */
  fsync(s->active_fd);
  return kv_open_active(s, (uint16_t)(s->active_id + 1), 0);
}

static int kv_replay_segment(kv_store *s, uint16_t id) {
  char path[3200];
  kv_seg_path(s, id, path, sizeof(path));
  FILE *f = fopen(path, "rb");
  if (!f) return 0; /* missing = fine */
  uint8_t hdr[KV_HDR];
  uint8_t *buf = NULL;
  size_t buf_cap = 0;
  uint64_t off = 0;
  for (;;) {
    if (fread(hdr, 1, KV_HDR, f) != KV_HDR) break;
    uint32_t crc, vlen;
    uint16_t klen;
    uint8_t op = hdr[4];
    memcpy(&crc, hdr, 4);
    memcpy(&klen, hdr + 5, 2);
    memcpy(&vlen, hdr + 7, 4);
    size_t need = (size_t)klen + vlen;
    if (need > (64u << 20)) break; /* corrupt length */
    if (need > buf_cap) {
      uint8_t *nb = realloc(buf, need ? need : 1);
      if (!nb) break;
      buf = nb;
      buf_cap = need;
    }
    if (fread(buf, 1, need, f) != need) break; /* torn tail */
    uint32_t want = kv_crc32(0, hdr + 4, KV_HDR - 4);
    want = kv_crc32(want, buf, klen);
    if (vlen) want = kv_crc32(want, buf + klen, vlen);
    if (want != crc) break; /* torn/corrupt: stop this segment */
    if (op == 0) {
      kv_slot *e = kv_find(s, buf, klen);
      if (e->key_off != UINT64_MAX && e->val_len != KV_DELETED) {
        uint64_t old = KV_HDR + e->key_len + e->val_len;
        s->dead_bytes += old;
        s->live_bytes -= old < s->live_bytes ? old : s->live_bytes;
      }
      kv_index_put(s, buf, klen, id, off + KV_HDR + klen, vlen);
      s->live_bytes += KV_HDR + klen + vlen;
    } else {
      kv_slot *e = kv_find(s, buf, klen);
      if (e->key_off != UINT64_MAX && e->val_len != KV_DELETED) {
        uint64_t old = KV_HDR + e->key_len + e->val_len;
        s->dead_bytes += old;
        s->live_bytes -= old < s->live_bytes ? old : s->live_bytes;
      }
      kv_index_del(s, buf, klen);
      s->dead_bytes += KV_HDR + klen;
    }
    off += KV_HDR + need;
  }
  free(buf);
  fclose(f);
  return 0;
}

/* ---------------- public API ---------------- */

kv_store *lodestar_kv_open_with(const char *dir, uint64_t seg_limit,
                                int verify_reads) {
  kv_crc_init();
  if (mkdir(dir, 0755) != 0 && errno != EEXIST) return NULL;
  kv_store *s = calloc(1, sizeof(kv_store));
  if (!s) return NULL;
  snprintf(s->dir, sizeof(s->dir), "%s", dir);
  s->active_fd = -1;
  s->read_fd = -1;
  s->read_fd_id = -1;
  s->seg_limit = seg_limit;
  s->verify_reads = verify_reads;
  if (kv_grow(s) != 0) {
    free(s);
    return NULL;
  }
  /* compaction crash recovery (see lodestar_kv_compact swap protocol) */
  {
    char marker[3200];
    snprintf(marker, sizeof(marker), "%s/compact.done", dir);
    FILE *mf = fopen(marker, "rb");
    int new_max = -1;
    if (mf) {
      if (fscanf(mf, "%d", &new_max) != 1) new_max = -1;
      fclose(mf);
    }
    DIR *rd = opendir(dir);
    if (rd) {
      struct dirent *ent;
      while ((ent = readdir(rd)) != NULL) {
        unsigned id;
        /* CAUTION: sscanf counts conversions even when trailing literal
         * text doesn't fully match ("seg-00000.kv" matches the pattern
         * below!) — require the exact ".kv.new" name shape explicitly */
        size_t L = strlen(ent->d_name);
        if (L == strlen("seg-00000.kv.new") &&
            sscanf(ent->d_name, "seg-%05u.kv", &id) == 1 &&
            strcmp(ent->d_name + L - 7, ".kv.new") == 0) {
          char from[3300], to[3200];
          snprintf(from, sizeof(from), "%s/%s", dir, ent->d_name);
          snprintf(to, sizeof(to), "%s/seg-%05u.kv", dir, id);
          if (new_max >= 0 && (int)id <= new_max) {
            rename(from, to); /* finish the interrupted promotion */
          } else {
            unlink(from); /* incomplete compaction: old gen is intact */
          }
        }
      }
      closedir(rd);
    }
    if (new_max >= 0) {
      /* drop old-generation finals beyond the new generation */
      DIR *rd2 = opendir(dir);
      if (rd2) {
        struct dirent *ent;
        while ((ent = readdir(rd2)) != NULL) {
          unsigned id;
          if (sscanf(ent->d_name, "seg-%05u.kv", &id) == 1 &&
              strlen(ent->d_name) == strlen("seg-00000.kv") &&
              (int)id > new_max) {
            char p[3300];
            snprintf(p, sizeof(p), "%s/%s", dir, ent->d_name);
            unlink(p);
          }
        }
        closedir(rd2);
      }
      unlink(marker);
    }
  }
  /* replay existing segments in id order */
  int max_id = -1;
  DIR *d = opendir(dir);
  if (d) {
    struct dirent *ent;
    while ((ent = readdir(d)) != NULL) {
      unsigned id;
      if (strlen(ent->d_name) == strlen("seg-00000.kv") &&
          sscanf(ent->d_name, "seg-%05u.kv", &id) == 1) {
        if ((int)id > max_id) max_id = (int)id;
      }
    }
    closedir(d);
  }
  for (int id = 0; id <= max_id; id++) kv_replay_segment(s, (uint16_t)id);
  if (kv_open_active(s, (uint16_t)(max_id < 0 ? 0 : max_id), 0) != 0) {
    free(s->slots);
    free(s->arena);
    free(s);
    return NULL;
  }
  return s;
}

kv_store *lodestar_kv_open(const char *dir) {
  return lodestar_kv_open_with(dir, 0, 0);
}

int lodestar_kv_put(kv_store *s, const uint8_t *key, size_t klen,
                    const uint8_t *val, size_t vlen, int sync) {
  if (klen == 0 || klen > 60000 || vlen > (64u << 20) - 1) return -1;
  kv_slot *e = kv_find(s, key, klen);
  if (e->key_off != UINT64_MAX && e->val_len != KV_DELETED) {
    uint64_t old = KV_HDR + e->key_len + e->val_len;
    s->dead_bytes += old;
    s->live_bytes -= old < s->live_bytes ? old : s->live_bytes;
  }
  uint64_t voff;
  if (kv_append_record(s, 0, key, (uint16_t)klen, val, (uint32_t)vlen, &voff))
    return -1;
  if (kv_index_put(s, key, klen, s->active_id, voff, (uint32_t)vlen)) return -1;
  s->live_bytes += KV_HDR + klen + vlen;
  if (sync) fsync(s->active_fd);
  return kv_maybe_rotate(s);
}

int lodestar_kv_delete(kv_store *s, const uint8_t *key, size_t klen,
                       int sync) {
  kv_slot *e = kv_find(s, key, klen);
  if (e->key_off == UINT64_MAX || e->val_len == KV_DELETED) return 0;
  {
    uint64_t old = KV_HDR + e->key_len + e->val_len;
    s->dead_bytes += old + KV_HDR + klen;
    s->live_bytes -= old < s->live_bytes ? old : s->live_bytes;
  }
  if (kv_append_record(s, 1, key, (uint16_t)klen, NULL, 0, NULL)) return -1;
  kv_index_del(s, key, klen);
  if (sync) fsync(s->active_fd);
  return 0;
}

int lodestar_kv_sync(kv_store *s) { return fsync(s->active_fd); }

/* get: returns value length, or -1 if absent, -2 on IO error. Caller
 * provides a buffer via out/out_cap; if too small, returns length anyway
 * (caller retries with bigger buffer). */
int64_t lodestar_kv_get(kv_store *s, const uint8_t *key, size_t klen,
                        uint8_t *out, size_t out_cap) {
  kv_slot *e = kv_find(s, key, klen);
  if (e->key_off == UINT64_MAX || e->val_len == KV_DELETED) return -1;
  if (out_cap < e->val_len) return (int64_t)e->val_len;
  int fd;
  if (e->file_id == s->active_id) {
    fd = s->active_fd;
  } else if (s->read_fd >= 0 && s->read_fd_id == (int)e->file_id) {
    fd = s->read_fd; /* sealed-segment fd cache: archive sweeps reuse it */
  } else {
    char path[3200];
    kv_seg_path(s, e->file_id, path, sizeof(path));
    fd = open(path, O_RDONLY);
    if (fd < 0) return -2;
    if (s->read_fd >= 0) close(s->read_fd);
    s->read_fd = fd;
    s->read_fd_id = (int)e->file_id;
  }
  ssize_t got = pread(fd, out, e->val_len, (off_t)e->val_off);
  if (got != (ssize_t)e->val_len) return -2;
  /* verify the record CRC (header+key live just before the value): a
   * stale fd or corrupted segment must surface as -2, never as silently
   * wrong value bytes */
  if (s->verify_reads) {
    uint8_t hk[KV_HDR + 256];
    uint8_t *hkp = hk;
    size_t hklen = KV_HDR + e->key_len;
    if (hklen > sizeof(hk)) {
      hkp = malloc(hklen);
      if (!hkp) return -2;
    }
    off_t rec_off = (off_t)e->val_off - (off_t)hklen;
    int ok = rec_off >= 0 && pread(fd, hkp, hklen, rec_off) == (ssize_t)hklen;
    if (ok) {
      uint32_t crc_stored;
      memcpy(&crc_stored, hkp, 4);
      uint32_t want = kv_crc32(0, hkp + 4, KV_HDR - 4);
      want = kv_crc32(want, hkp + KV_HDR, e->key_len);
      if (e->val_len) want = kv_crc32(want, out, e->val_len);
      ok = want == crc_stored &&
           memcmp(hkp + KV_HDR, key, klen < e->key_len ? klen : e->key_len) == 0;
    }
    if (hkp != hk) free(hkp);
    if (!ok) return -2;
  }
  return (int64_t)e->val_len;
}

/* collect keys in [gte, lt), sorted. Returns count; fills offsets/lengths
 * into caller arrays up to max_out. Two-pass friendly: call with
 * max_out=0 to count. */
typedef struct {
  const uint8_t *key;
  uint16_t len;
} kv_keyref;

static int kv_keyref_cmp(const void *a, const void *b) {
  const kv_keyref *x = a, *y = b;
  size_t n = x->len < y->len ? x->len : y->len;
  int c = memcmp(x->key, y->key, n);
  if (c) return c;
  return (int)x->len - (int)y->len;
}

static int kv_in_range(const uint8_t *k, uint16_t klen, const uint8_t *gte,
                       size_t gl, const uint8_t *lt, size_t ll) {
  kv_keyref a = {k, klen};
  kv_keyref g = {gte, (uint16_t)gl};
  kv_keyref l = {lt, (uint16_t)ll};
  if (gl && kv_keyref_cmp(&a, &g) < 0) return 0;
  if (ll && kv_keyref_cmp(&a, &l) >= 0) return 0;
  return 1;
}

/* returns a malloc'd array of keyrefs (caller frees) sorted ascending */
kv_keyref *lodestar_kv_range(kv_store *s, const uint8_t *gte, size_t gl,
                             const uint8_t *lt, size_t ll, uint64_t *n_out) {
  uint64_t n = 0;
  for (uint64_t i = 0; i < s->cap; i++) {
    kv_slot *e = &s->slots[i];
    if (e->key_off == UINT64_MAX || e->val_len == KV_DELETED) continue;
    if (kv_in_range(kv_key_at(s, e), e->key_len, gte, gl, lt, ll)) n++;
  }
  kv_keyref *arr = malloc((n ? n : 1) * sizeof(kv_keyref));
  if (!arr) {
    *n_out = 0;
    return NULL;
  }
  uint64_t j = 0;
  for (uint64_t i = 0; i < s->cap; i++) {
    kv_slot *e = &s->slots[i];
    if (e->key_off == UINT64_MAX || e->val_len == KV_DELETED) continue;
    if (kv_in_range(kv_key_at(s, e), e->key_len, gte, gl, lt, ll)) {
      arr[j].key = kv_key_at(s, e);
      arr[j].len = e->key_len;
      j++;
    }
  }
  qsort(arr, n, sizeof(kv_keyref), kv_keyref_cmp);
  *n_out = n;
  return arr;
}

/* frees what lodestar_kv_range returned (a binding without the C
 * library's free calls this) */
void lodestar_kv_free(void *p) { free(p); }

uint64_t lodestar_kv_count(kv_store *s) {
  uint64_t n = 0;
  for (uint64_t i = 0; i < s->cap; i++)
    if (s->slots[i].key_off != UINT64_MAX && s->slots[i].val_len != KV_DELETED)
      n++;
  return n;
}

void lodestar_kv_stats(kv_store *s, uint64_t out[4]) {
  out[0] = lodestar_kv_count(s);
  out[1] = s->live_bytes;
  out[2] = s->dead_bytes;
  out[3] = (uint64_t)s->active_id;
}

/* unlink every regular file in dir (best-effort; missing dir is fine). */
static void kv_purge_dir(const char *dir) {
  DIR *d = opendir(dir);
  if (!d) return;
  struct dirent *de;
  char p[3400];
  while ((de = readdir(d)) != NULL) {
    if (de->d_name[0] == '.') continue;
    snprintf(p, sizeof(p), "%s/%s", dir, de->d_name);
    unlink(p);
  }
  closedir(d);
}

/* compaction: rewrite live records into a fresh segment line. */
int lodestar_kv_compact(kv_store *s) {
  char tmpdir[3200];
  snprintf(tmpdir, sizeof(tmpdir), "%s/compact.tmp", s->dir);
  /* purge leftovers from any previously-failed compaction BEFORE opening:
   * stale segments in compact.tmp would be replayed by lodestar_kv_open
   * into the new generation and could resurrect keys deleted since the
   * failed run. */
  kv_purge_dir(tmpdir);
  kv_store *ns = lodestar_kv_open_with(tmpdir, s->seg_limit, 0);
  if (!ns) return -1;
  uint8_t *vbuf = NULL;
  size_t vcap = 0;
  int rc = 0;
  int saved_verify = s->verify_reads;
  s->verify_reads = 1; /* never copy corrupt bytes into the new generation */
  for (uint64_t i = 0; i < s->cap && rc == 0; i++) {
    kv_slot *e = &s->slots[i];
    if (e->key_off == UINT64_MAX || e->val_len == KV_DELETED) continue;
    if (e->val_len > vcap) {
      uint8_t *nb = realloc(vbuf, e->val_len);
      if (!nb) {
        rc = -1;
        break;
      }
      vbuf = nb;
      vcap = e->val_len;
    }
    int64_t got = lodestar_kv_get(s, kv_key_at(s, e), e->key_len, vbuf, vcap);
    if (got < 0) {
      rc = -1;
      break;
    }
    rc = lodestar_kv_put(ns, kv_key_at(s, e), e->key_len, vbuf,
                         (size_t)got, 0);
  }
  s->verify_reads = saved_verify;
  free(vbuf);
  if (rc == 0) rc = lodestar_kv_sync(ns);
  if (rc != 0) {
    /* abandon: close AND purge the tmp segments so they cannot be
     * replayed into a later compaction's new generation */
    void lodestar_kv_close(kv_store *);
    lodestar_kv_close(ns);
    kv_purge_dir(tmpdir);
    rmdir(tmpdir);
    return -1;
  }
  /* crash-safe swap (unlink-all-then-rename would lose the
   * whole db on a crash in the window). Protocol:
   *   1. rename new segments into the main dir as seg-NNNNN.kv.new
   *   2. write + fsync a compact.done marker carrying the new max id
   *   3. unlink old finals, promote .new -> final, remove the marker
   * Recovery in lodestar_kv_open: with a valid marker, finish step 3;
   * without one, discard any .new leftovers (old generation is intact —
   * compaction is logically a no-op, so either complete generation is
   * correct). */
  for (int id = 0; rc == 0 && id <= (int)ns->active_id; id++) {
    char from[3250], to[3300];
    kv_seg_path(ns, (uint16_t)id, from, sizeof(from));
    kv_seg_path(s, (uint16_t)id, to, sizeof(to) - 5);
    strcat(to, ".new");
    if (rename(from, to) != 0) rc = -1;
  }
  char marker[3200];
  snprintf(marker, sizeof(marker), "%s/compact.done", s->dir);
  if (rc == 0) {
    int mfd = open(marker, O_CREAT | O_WRONLY | O_TRUNC, 0644);
    if (mfd >= 0) {
      char buf[32];
      int n = snprintf(buf, sizeof(buf), "%d\n", (int)ns->active_id);
      if (write(mfd, buf, n) != n) rc = -1;
      fsync(mfd);
      close(mfd);
    } else {
      rc = -1;
    }
  }
  if (rc != 0) {
    /* stage-1/2 failure: the old generation is fully intact on disk and
     * nothing was promoted — do NOT adopt the new index (adopting here
     * would point every get at files that don't exist). Clean up the
     * .new leftovers and keep serving the old state. */
    for (int id = 0; id <= (int)ns->active_id; id++) {
      char to[3200], from[3300];
      kv_seg_path(s, (uint16_t)id, to, sizeof(to));
      snprintf(from, sizeof(from), "%s.new", to);
      unlink(from);
    }
    unlink(marker);
    lodestar_kv_close(ns);
    kv_purge_dir(tmpdir); /* segments the rename loop never reached */
    rmdir(tmpdir);
    return -1;
  }
  for (int id = 0; id <= (int)s->active_id; id++) {
    char p[3200];
    kv_seg_path(s, (uint16_t)id, p, sizeof(p));
    unlink(p);
  }
  for (int id = 0; id <= (int)ns->active_id; id++) {
    char from[3300], to[3200];
    kv_seg_path(s, (uint16_t)id, to, sizeof(to));
    snprintf(from, sizeof(from), "%s.new", to);
    if (rename(from, to) != 0) rc = -1;
    /* a promote-stage rename failure is still adopted below: the old
     * finals are gone and the fsync'd marker lets open-time recovery
     * finish the promotion */
  }
  if (rc == 0) unlink(marker); /* keep the marker while recovery needs it */
  rmdir(tmpdir);
  /* adopt the new store's state in place */
  close(s->active_fd);
  if (ns->active_fd >= 0) close(ns->active_fd);
  free(s->slots);
  free(s->arena);
  s->slots = ns->slots;
  s->cap = ns->cap;
  s->count = ns->count;
  s->arena = ns->arena;
  s->arena_len = ns->arena_len;
  s->arena_cap = ns->arena_cap;
  s->arena_dead = 0;
  s->live_bytes = ns->live_bytes;
  s->dead_bytes = 0;
  s->active_fd = -1;
  /* the sealed-segment fd cache points at a pre-compaction file that was
   * just unlinked; a post-compaction get whose entry shares the cached
   * file_id would pread the dead file at new-generation offsets and
   * return wrong bytes — drop the cache with the old generation */
  if (s->read_fd >= 0) close(s->read_fd);
  s->read_fd = -1;
  s->read_fd_id = -1;
  uint16_t new_active = ns->active_id;
  free(ns);
  return kv_open_active(s, new_active, 0) || rc;
}

int lodestar_kv_should_compact(kv_store *s) {
  return s->dead_bytes > KV_COMPACT_MIN &&
         s->dead_bytes > s->live_bytes * KV_COMPACT_RATIO;
}

void lodestar_kv_close(kv_store *s) {
  if (!s) return;
  if (s->active_fd >= 0) {
    fsync(s->active_fd);
    close(s->active_fd);
  }
  if (s->read_fd >= 0) close(s->read_fd);
  free(s->slots);
  free(s->arena);
  free(s);
}
