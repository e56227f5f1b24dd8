/* Native BLS12-381 host tier: the marshalling fast path.
 *
 * The port's copy of lodestar_tpu/native/src/bls12.c (with its generated
 * bls12_consts.h and sha256.c), built with `cc` and loaded through this
 * plain C ABI by lodestar_tpu_torch/native/.  It adds lodestar_bls_sk_to_pk
 * (for making test and benchmark data) and lodestar_bls_g2_aggregate, and
 * its lodestar_bls_g1_aggregate returns the compressed sum rather than
 * device limbs.
 *
 * Replaces the pure-Python big-int hot path between wire bytes and the
 * device verifier (reference analog: blst's in-C preprocessing used by
 * chain/bls/multithread/worker.ts:33-55 and main-thread aggregation
 * bls/utils.ts:5-16).  Scope:
 *
 *   - G1/G2 point decompression (ZCash flags) + on-curve + subgroup checks
 *   - SSWU hash-to-curve for G2 (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_)
 *   - G1 pubkey and G2 signature aggregation
 *   - batched signature-set marshalling straight into the device's
 *     32x12-bit Montgomery limb layout (ops/limbs.py)
 *
 * Field arithmetic: 6x64-bit limbs, Montgomery form (R = 2^384), CIOS
 * multiplication with __uint128_t.  All constants are generated from the
 * Python oracle (gen_bls12_consts.py) so the two tiers cannot disagree.
 * Scalar multiplications here are variable-time: every input is public
 * (signatures, pubkeys, message hashes) — no secrets are processed.
 */

#include <stdint.h>
#include <string.h>
#include <stddef.h>

#include "bls12_consts.h"

void lodestar_sha256(const uint8_t *data, size_t len, uint8_t out[32]);

typedef uint64_t fp[6];
typedef struct { fp c0, c1; } fp2;
typedef struct { fp X, Y, Z; } g1p;   /* jacobian; Z==0 -> infinity */
typedef struct { fp2 X, Y, Z; } g2p;

/* ---------------- fp ---------------- */

static void fp_copy(fp r, const fp a) { memcpy(r, a, sizeof(fp)); }
static void fp_zero(fp r) { memset(r, 0, sizeof(fp)); }
static int fp_is_zero(const fp a) {
  return (a[0] | a[1] | a[2] | a[3] | a[4] | a[5]) == 0;
}
static int fp_eq(const fp a, const fp b) { return memcmp(a, b, sizeof(fp)) == 0; }

/* a >= b (both < 2^384) */
static int fp_cmp_ge(const uint64_t *a, const uint64_t *b, int n) {
  for (int i = n - 1; i >= 0; i--) {
    if (a[i] > b[i]) return 1;
    if (a[i] < b[i]) return 0;
  }
  return 1;
}

static void fp_sub_raw(uint64_t *r, const uint64_t *a, const uint64_t *b, int n) {
  unsigned __int128 borrow = 0;
  for (int i = 0; i < n; i++) {
    unsigned __int128 d = (unsigned __int128)a[i] - b[i] - (uint64_t)borrow;
    r[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static void fp_add(fp r, const fp a, const fp b) {
  unsigned __int128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += (unsigned __int128)a[i] + b[i];
    r[i] = (uint64_t)c;
    c >>= 64;
  }
  if (c || fp_cmp_ge(r, BLS_P, 6)) {
    /* subtract p (carry c can only be 0 here since 2p < 2^384+p... handle both) */
    uint64_t t[6];
    fp_sub_raw(t, r, BLS_P, 6);
    /* if there was a carry out, the subtraction is unconditionally right */
    fp_copy(r, t);
  }
}

static void fp_sub(fp r, const fp a, const fp b) {
  if (fp_cmp_ge(a, b, 6)) {
    fp_sub_raw(r, a, b, 6);
  } else {
    uint64_t t[6];
    unsigned __int128 c = 0;
    for (int i = 0; i < 6; i++) {
      c += (unsigned __int128)a[i] + BLS_P[i];
      t[i] = (uint64_t)c;
      c >>= 64;
    }
    fp_sub_raw(r, t, b, 6);
  }
}

static void fp_neg(fp r, const fp a) {
  if (fp_is_zero(a)) { fp_zero(r); return; }
  fp_sub_raw(r, BLS_P, a, 6);
}

/* CIOS Montgomery multiplication: r = a*b*R^-1 mod p, result < p. */
static void fp_mul(fp r, const fp a, const fp b) {
  uint64_t t[8];
  memset(t, 0, sizeof(t));
  for (int i = 0; i < 6; i++) {
    unsigned __int128 c = 0;
    for (int j = 0; j < 6; j++) {
      c += (unsigned __int128)a[j] * b[i] + t[j];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[6] = (uint64_t)c;
    t[7] = (uint64_t)(c >> 64);

    uint64_t m = t[0] * BLS_N0;
    c = (unsigned __int128)m * BLS_P[0] + t[0];
    c >>= 64;
    for (int j = 1; j < 6; j++) {
      c += (unsigned __int128)m * BLS_P[j] + t[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[5] = (uint64_t)c;
    t[6] = t[7] + (uint64_t)(c >> 64);
  }
  if (t[6] || fp_cmp_ge(t, BLS_P, 6)) fp_sub_raw(t, t, BLS_P, 6);
  memcpy(r, t, sizeof(fp));
}

static void fp_sqr(fp r, const fp a) { fp_mul(r, a, a); }

/* a^e for little-endian word exponent (variable time; public data only). */
static void fp_exp(fp r, const fp a, const uint64_t *e, int words) {
  fp acc;
  fp_copy(acc, BLS_ONE_M);
  int started = 0;
  for (int w = words - 1; w >= 0; w--) {
    for (int b = 63; b >= 0; b--) {
      if (started) fp_sqr(acc, acc);
      if ((e[w] >> b) & 1) {
        if (started) fp_mul(acc, acc, a);
        else { fp_copy(acc, a); started = 1; }
      }
    }
  }
  fp_copy(r, acc);
}

static void fp_inv(fp r, const fp a) { fp_exp(r, a, BLS_EXP_INV, 6); }

/* sqrt (p = 3 mod 4): cand = a^((p+1)/4); returns 0 if a is not a QR. */
static int fp_sqrt(fp r, const fp a) {
  fp cand, chk;
  fp_exp(cand, a, BLS_EXP_SQRT, 6);
  fp_sqr(chk, cand);
  if (!fp_eq(chk, a)) return 0;
  fp_copy(r, cand);
  return 1;
}

/* Montgomery -> canonical integer (little-endian words). */
static void fp_from_mont(uint64_t out[6], const fp a) {
  fp one = {1, 0, 0, 0, 0, 0};
  fp_mul((uint64_t *)out, a, one);
}

static void fp_to_mont(fp r, const uint64_t in[6]) { fp_mul(r, in, BLS_R2); }

static int fp_sgn0(const fp a) {
  uint64_t c[6];
  fp_from_mont(c, a);
  return (int)(c[0] & 1);
}

static int fp_lex_larger(const fp a) {
  uint64_t c[6];
  fp_from_mont(c, a);
  /* canonical > (p-1)/2 */
  for (int i = 5; i >= 0; i--) {
    if (c[i] > BLS_HALF_P[i]) return 1;
    if (c[i] < BLS_HALF_P[i]) return 0;
  }
  return 0; /* equal -> not larger */
}

/* 48 big-endian bytes -> canonical words; returns 0 if >= p. */
static int fp_from_be(uint64_t out[6], const uint8_t in[48]) {
  for (int i = 0; i < 6; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[(5 - i) * 8 + j];
    out[i] = w;
  }
  return !fp_cmp_ge(out, BLS_P, 6);
}

/* Montgomery fp -> 32x12-bit int32 device limbs (value = a*R mod p). */
static void fp_to_limbs12(int32_t out[32], const fp a) {
  /* the Montgomery residue itself is what the device stores */
  const uint64_t *w = a;
  for (int i = 0; i < 32; i++) {
    int bit = i * 12;
    int word = bit >> 6, off = bit & 63;
    uint64_t v = w[word] >> off;
    if (off > 52 && word < 5) v |= w[word + 1] << (64 - off);
    out[i] = (int32_t)(v & 0xFFF);
  }
}

/* ---------------- fp2 ---------------- */

static void fp2_copy(fp2 *r, const fp2 *a) { *r = *a; }
static void fp2_zero(fp2 *r) { fp_zero(r->c0); fp_zero(r->c1); }
static int fp2_is_zero(const fp2 *a) { return fp_is_zero(a->c0) && fp_is_zero(a->c1); }
static int fp2_eq(const fp2 *a, const fp2 *b) {
  return fp_eq(a->c0, b->c0) && fp_eq(a->c1, b->c1);
}
static void fp2_one(fp2 *r) { fp_copy(r->c0, BLS_ONE_M); fp_zero(r->c1); }

static void fp2_add(fp2 *r, const fp2 *a, const fp2 *b) {
  fp_add(r->c0, a->c0, b->c0);
  fp_add(r->c1, a->c1, b->c1);
}
static void fp2_sub(fp2 *r, const fp2 *a, const fp2 *b) {
  fp_sub(r->c0, a->c0, b->c0);
  fp_sub(r->c1, a->c1, b->c1);
}
static void fp2_neg(fp2 *r, const fp2 *a) {
  fp_neg(r->c0, a->c0);
  fp_neg(r->c1, a->c1);
}
static void fp2_conj(fp2 *r, const fp2 *a) {
  fp_copy(r->c0, a->c0);
  fp_neg(r->c1, a->c1);
}

static void fp2_mul(fp2 *r, const fp2 *a, const fp2 *b) {
  fp t0, t1, t2, t3, s0, s1;
  fp_mul(t0, a->c0, b->c0);
  fp_mul(t1, a->c1, b->c1);
  fp_add(t2, a->c0, a->c1);
  fp_add(t3, b->c0, b->c1);
  fp_mul(t2, t2, t3);          /* (a0+a1)(b0+b1) */
  fp_sub(s0, t0, t1);          /* c0 = a0b0 - a1b1 */
  fp_sub(t2, t2, t0);
  fp_sub(s1, t2, t1);          /* c1 = cross */
  fp_copy(r->c0, s0);
  fp_copy(r->c1, s1);
}

static void fp2_sqr(fp2 *r, const fp2 *a) {
  fp t0, t1, s0;
  fp_add(t0, a->c0, a->c1);
  fp_sub(t1, a->c0, a->c1);
  fp_mul(s0, t0, t1);          /* (a0+a1)(a0-a1) */
  fp_mul(t0, a->c0, a->c1);
  fp_copy(r->c0, s0);
  fp_add(r->c1, t0, t0);       /* 2 a0 a1 */
}

static void fp2_mul_fp(fp2 *r, const fp2 *a, const fp k) {
  fp_mul(r->c0, a->c0, k);
  fp_mul(r->c1, a->c1, k);
}

static void fp2_inv(fp2 *r, const fp2 *a) {
  fp n, n0, n1;
  fp_sqr(n0, a->c0);
  fp_sqr(n1, a->c1);
  fp_add(n, n0, n1);
  fp_inv(n, n);
  fp_mul(r->c0, a->c0, n);
  fp_mul(n, a->c1, n);
  fp_neg(r->c1, n);
}

static void fp2_exp(fp2 *r, const fp2 *a, const uint64_t *e, int words) {
  fp2 acc;
  fp2_one(&acc);
  int started = 0;
  for (int w = words - 1; w >= 0; w--) {
    for (int b = 63; b >= 0; b--) {
      if (started) fp2_sqr(&acc, &acc);
      if ((e[w] >> b) & 1) {
        if (started) fp2_mul(&acc, &acc, a);
        else { fp2_copy(&acc, a); started = 1; }
      }
    }
  }
  fp2_copy(r, &acc);
}

/* Fq2 sqrt: cand = a^((p^2+7)/16) corrected by {1, i, w, iw}. 0 = not a QR. */
static int fp2_sqrt(fp2 *r, const fp2 *a) {
  if (fp2_is_zero(a)) { fp2_zero(r); return 1; }
  fp2 cand, s, chk;
  fp2_exp(&cand, a, BLS_EXP_SQRT_FQ2, 12);
  for (int i = 0; i < 4; i++) {
    fp2 corr;
    fp_copy(corr.c0, BLS_SQRT_CORR[i][0]);
    fp_copy(corr.c1, BLS_SQRT_CORR[i][1]);
    fp2_mul(&s, &cand, &corr);
    fp2_sqr(&chk, &s);
    if (fp2_eq(&chk, a)) { fp2_copy(r, &s); return 1; }
  }
  return 0;
}

static int fp2_sgn0(const fp2 *a) {
  /* RFC 9380 sgn0, m=2 */
  uint64_t c0[6];
  fp_from_mont(c0, a->c0);
  int sign_0 = (int)(c0[0] & 1);
  int zero_0 = 1;
  for (int i = 0; i < 6; i++) zero_0 &= (c0[i] == 0);
  int sign_1 = fp_sgn0(a->c1);
  return sign_0 | (zero_0 & sign_1);
}

static int fp2_lex_larger(const fp2 *y) {
  /* ZCash convention: compare (c1, c0) lexicographically with (p-1)/2 */
  if (!fp_is_zero(y->c1)) return fp_lex_larger(y->c1);
  return fp_lex_larger(y->c0);
}

/* ---------------- G1 (jacobian) ---------------- */

static void g1_infinity(g1p *r) {
  fp_copy(r->X, BLS_ONE_M);
  fp_copy(r->Y, BLS_ONE_M);
  fp_zero(r->Z);
}
static int g1_is_infinity(const g1p *p) { return fp_is_zero(p->Z); }

static void g1_dbl(g1p *r, const g1p *p) {
  if (g1_is_infinity(p)) { *r = *p; return; }
  fp A, B, C, D, E, F, t;
  fp_sqr(A, p->X);
  fp_sqr(B, p->Y);
  fp_sqr(C, B);
  fp_add(t, p->X, B);
  fp_sqr(t, t);
  fp_sub(t, t, A);
  fp_sub(t, t, C);
  fp_add(D, t, t);            /* 2((X+B)^2 - A - C) */
  fp_add(E, A, A);
  fp_add(E, E, A);            /* 3A */
  fp_sqr(F, E);
  fp t2;
  fp_add(t2, D, D);
  fp_sub(F, F, t2);           /* X3 = F - 2D */
  fp Y3;
  fp_sub(Y3, D, F);
  fp_mul(Y3, E, Y3);
  fp C8;
  fp_add(C8, C, C);
  fp_add(C8, C8, C8);
  fp_add(C8, C8, C8);         /* 8C */
  fp_sub(Y3, Y3, C8);
  fp Z3;
  fp_mul(Z3, p->Y, p->Z);
  fp_add(Z3, Z3, Z3);
  fp_copy(r->X, F);
  fp_copy(r->Y, Y3);
  fp_copy(r->Z, Z3);
}

static void g1_add(g1p *r, const g1p *p, const g1p *q) {
  if (g1_is_infinity(p)) { *r = *q; return; }
  if (g1_is_infinity(q)) { *r = *p; return; }
  fp Z1Z1, Z2Z2, U1, U2, S1, S2, H, rr, t;
  fp_sqr(Z1Z1, p->Z);
  fp_sqr(Z2Z2, q->Z);
  fp_mul(U1, p->X, Z2Z2);
  fp_mul(U2, q->X, Z1Z1);
  fp_mul(t, q->Z, Z2Z2);
  fp_mul(S1, p->Y, t);
  fp_mul(t, p->Z, Z1Z1);
  fp_mul(S2, q->Y, t);
  fp_sub(H, U2, U1);
  fp_sub(rr, S2, S1);
  if (fp_is_zero(H)) {
    if (fp_is_zero(rr)) { g1_dbl(r, p); return; }
    g1_infinity(r);
    return;
  }
  fp I, J, r2, V, X3, Y3, Z3;
  fp_add(t, H, H);
  fp_sqr(I, t);               /* (2H)^2 */
  fp_mul(J, H, I);
  fp_add(r2, rr, rr);
  fp_mul(V, U1, I);
  fp_sqr(X3, r2);
  fp_sub(X3, X3, J);
  fp_sub(X3, X3, V);
  fp_sub(X3, X3, V);
  fp_sub(Y3, V, X3);
  fp_mul(Y3, r2, Y3);
  fp_mul(t, S1, J);
  fp_add(t, t, t);
  fp_sub(Y3, Y3, t);
  fp_add(Z3, p->Z, q->Z);
  fp_sqr(Z3, Z3);
  fp_sub(Z3, Z3, Z1Z1);
  fp_sub(Z3, Z3, Z2Z2);
  fp_mul(Z3, Z3, H);
  fp_copy(r->X, X3);
  fp_copy(r->Y, Y3);
  fp_copy(r->Z, Z3);
}

static void g1_scalar_mul(g1p *r, const g1p *p, const uint64_t *k, int words) {
  g1p acc;
  g1_infinity(&acc);
  int started = 0;
  for (int w = words - 1; w >= 0; w--) {
    for (int b = 63; b >= 0; b--) {
      if (started) g1_dbl(&acc, &acc);
      if ((k[w] >> b) & 1) {
        if (started) g1_add(&acc, &acc, p);
        else { acc = *p; started = 1; }
      }
    }
  }
  if (!started) g1_infinity(&acc);
  *r = acc;
}

/* GLV endomorphism φ(x,y) = (β·x, y), β = 2^((p-1)/3) (Montgomery form).
 * On G1, φ acts as multiplication by −x² (verified against the Python
 * oracle, including completeness on random non-subgroup curve points:
 * tests/test_native_bls.py).  Fast membership: φ(P) + [x²]P == O —
 * a 128-bit ladder instead of the 255-bit order ladder. */
static const uint64_t BLS_BETA_M[6] = {
    0x30f1361b798a64e8ULL, 0xf3b8ddab7ece5a2aULL, 0x16a8ca3ac61577f7ULL,
    0xc26a2ff874fd029bULL, 0x3636b76660701c6eULL, 0x051ba4ab241b6160ULL};
static const uint64_t BLS_X_SQ[2] = {0x0000000100000000ULL,
                                     0xac45a4010001a402ULL};

static int g1_in_subgroup(const g1p *p) {
  if (g1_is_infinity(p)) return 1;
  g1p phi = *p, t;
  fp_mul(phi.X, phi.X, BLS_BETA_M);
  g1_scalar_mul(&t, p, BLS_X_SQ, 2);
  g1_add(&t, &t, &phi);
  return g1_is_infinity(&t);
}

static void g1_to_affine(fp x, fp y, const g1p *p) {
  fp zi, zi2;
  fp_inv(zi, p->Z);
  fp_sqr(zi2, zi);
  fp_mul(x, p->X, zi2);
  fp_mul(zi2, zi2, zi);
  fp_mul(y, p->Y, zi2);
}

/* ---------------- G2 (jacobian over fp2) ---------------- */

static void g2_infinity(g2p *r) {
  fp2_one(&r->X);
  fp2_one(&r->Y);
  fp2_zero(&r->Z);
}
static int g2_is_infinity(const g2p *p) { return fp2_is_zero(&p->Z); }

static void g2_dbl(g2p *r, const g2p *p) {
  if (g2_is_infinity(p)) { *r = *p; return; }
  fp2 A, B, C, D, E, F, t, t2, Y3, Z3, C8;
  fp2_sqr(&A, &p->X);
  fp2_sqr(&B, &p->Y);
  fp2_sqr(&C, &B);
  fp2_add(&t, &p->X, &B);
  fp2_sqr(&t, &t);
  fp2_sub(&t, &t, &A);
  fp2_sub(&t, &t, &C);
  fp2_add(&D, &t, &t);
  fp2_add(&E, &A, &A);
  fp2_add(&E, &E, &A);
  fp2_sqr(&F, &E);
  fp2_add(&t2, &D, &D);
  fp2_sub(&F, &F, &t2);
  fp2_sub(&Y3, &D, &F);
  fp2_mul(&Y3, &E, &Y3);
  fp2_add(&C8, &C, &C);
  fp2_add(&C8, &C8, &C8);
  fp2_add(&C8, &C8, &C8);
  fp2_sub(&Y3, &Y3, &C8);
  fp2_mul(&Z3, &p->Y, &p->Z);
  fp2_add(&Z3, &Z3, &Z3);
  fp2_copy(&r->X, &F);
  fp2_copy(&r->Y, &Y3);
  fp2_copy(&r->Z, &Z3);
}

static void g2_add(g2p *r, const g2p *p, const g2p *q) {
  if (g2_is_infinity(p)) { *r = *q; return; }
  if (g2_is_infinity(q)) { *r = *p; return; }
  fp2 Z1Z1, Z2Z2, U1, U2, S1, S2, H, rr, t, I, J, r2, V, X3, Y3, Z3;
  fp2_sqr(&Z1Z1, &p->Z);
  fp2_sqr(&Z2Z2, &q->Z);
  fp2_mul(&U1, &p->X, &Z2Z2);
  fp2_mul(&U2, &q->X, &Z1Z1);
  fp2_mul(&t, &q->Z, &Z2Z2);
  fp2_mul(&S1, &p->Y, &t);
  fp2_mul(&t, &p->Z, &Z1Z1);
  fp2_mul(&S2, &q->Y, &t);
  fp2_sub(&H, &U2, &U1);
  fp2_sub(&rr, &S2, &S1);
  if (fp2_is_zero(&H)) {
    if (fp2_is_zero(&rr)) { g2_dbl(r, p); return; }
    g2_infinity(r);
    return;
  }
  fp2_add(&t, &H, &H);
  fp2_sqr(&I, &t);
  fp2_mul(&J, &H, &I);
  fp2_add(&r2, &rr, &rr);
  fp2_mul(&V, &U1, &I);
  fp2_sqr(&X3, &r2);
  fp2_sub(&X3, &X3, &J);
  fp2_sub(&X3, &X3, &V);
  fp2_sub(&X3, &X3, &V);
  fp2_sub(&Y3, &V, &X3);
  fp2_mul(&Y3, &r2, &Y3);
  fp2_mul(&t, &S1, &J);
  fp2_add(&t, &t, &t);
  fp2_sub(&Y3, &Y3, &t);
  fp2_add(&Z3, &p->Z, &q->Z);
  fp2_sqr(&Z3, &Z3);
  fp2_sub(&Z3, &Z3, &Z1Z1);
  fp2_sub(&Z3, &Z3, &Z2Z2);
  fp2_mul(&Z3, &Z3, &H);
  fp2_copy(&r->X, &X3);
  fp2_copy(&r->Y, &Y3);
  fp2_copy(&r->Z, &Z3);
}

static void g2_neg(g2p *r, const g2p *p) {
  *r = *p;
  fp2_neg(&r->Y, &p->Y);
}

static void g2_scalar_mul(g2p *r, const g2p *p, const uint64_t *k, int words) {
  g2p acc;
  g2_infinity(&acc);
  int started = 0;
  for (int w = words - 1; w >= 0; w--) {
    for (int b = 63; b >= 0; b--) {
      if (started) g2_dbl(&acc, &acc);
      if ((k[w] >> b) & 1) {
        if (started) g2_add(&acc, &acc, p);
        else { acc = *p; started = 1; }
      }
    }
  }
  if (!started) g2_infinity(&acc);
  *r = acc;
}

static void g2_psi(g2p *r, const g2p *p);

/* Fast membership (Scott): P ∈ G2 ⟺ ψ(P) == [x]P; x is negative, so
 * check ψ(P) + [|x|]P == O — a 64-bit ladder instead of the 255-bit
 * order ladder.  Verified against the Python oracle including
 * completeness on random non-subgroup E'(Fp2) points
 * (tests/test_native_bls.py). */
static int g2_in_subgroup(const g2p *p) {
  if (g2_is_infinity(p)) return 1;
  g2p psi_p, t;
  g2_psi(&psi_p, p);
  g2_scalar_mul(&t, p, BLS_X_ABS, 1);
  g2_add(&t, &t, &psi_p);
  return g2_is_infinity(&t);
}

static void g2_to_affine(fp2 *x, fp2 *y, const g2p *p) {
  fp2 zi, zi2;
  fp2_inv(&zi, &p->Z);
  fp2_sqr(&zi2, &zi);
  fp2_mul(x, &p->X, &zi2);
  fp2_mul(&zi2, &zi2, &zi);
  fp2_mul(y, &p->Y, &zi2);
}

/* psi endomorphism on jacobian coords: conjugate everything, then scale
 * X by CX and Y by CY (valid because conj(X/Z^2) = conj(X)/conj(Z)^2). */
static void g2_psi(g2p *r, const g2p *p) {
  fp2 cx, cy;
  memcpy(&cx, BLS_PSI_CX, sizeof(fp2));
  memcpy(&cy, BLS_PSI_CY, sizeof(fp2));
  fp2 X, Y, Z;
  fp2_conj(&X, &p->X);
  fp2_conj(&Y, &p->Y);
  fp2_conj(&Z, &p->Z);
  fp2_mul(&r->X, &X, &cx);
  fp2_mul(&r->Y, &Y, &cy);
  fp2_copy(&r->Z, &Z);
}

/* Budroni-Pintore: h_eff.P = [S1]P + [S2]psi(P) + psi^2(2P), S2 < 0. */
static void g2_clear_cofactor(g2p *r, const g2p *p) {
  g2p t1, t2, t3, psi_p;
  g2_scalar_mul(&t1, p, BLS_BP_S1, 3);
  g2_psi(&psi_p, p);
  g2_scalar_mul(&t2, &psi_p, BLS_BP_S2_ABS, 2);
  g2_neg(&t2, &t2);
  g2_dbl(&t3, p);
  g2_psi(&t3, &t3);
  g2_psi(&t3, &t3);
  g2_add(&t1, &t1, &t2);
  g2_add(r, &t1, &t3);
}

/* ---------------- serialization ---------------- */

#define FLAG_C 0x80
#define FLAG_I 0x40
#define FLAG_S 0x20

/* Parse a 48B compressed G1 point into affine-Z=1 montgomery coords.
 * Returns 0 ok / 1 infinity / -1 malformed / -2 not on curve.  The ZCash
 * flag rules: C must be set; I implies all other payload bits zero.  No
 * subgroup check here — callers decide (single shared implementation for
 * decompress + aggregate, so validation policy lives in one place). */
static int g1_parse_compressed(const uint8_t in[48], g1p *out) {
  uint8_t flags = in[0];
  if (!(flags & FLAG_C)) return -1;
  if (flags & FLAG_I) {
    if (flags != (FLAG_C | FLAG_I)) return -1;
    for (int i = 1; i < 48; i++)
      if (in[i]) return -1;
    g1_infinity(out);
    return 1;
  }
  uint8_t buf[48];
  memcpy(buf, in, 48);
  buf[0] &= 0x1F;
  uint64_t xw[6];
  if (!fp_from_be(xw, buf)) return -1;
  fp x, y, y2, t;
  fp_to_mont(x, xw);
  fp_sqr(t, x);
  fp_mul(t, t, x);
  fp_add(y2, t, BLS_B1_M);
  if (!fp_sqrt(y, y2)) return -2;
  if (fp_lex_larger(y) != !!(flags & FLAG_S)) fp_neg(y, y);
  fp_copy(out->X, x);
  fp_copy(out->Y, y);
  fp_copy(out->Z, BLS_ONE_M);
  return 0;
}

/* returns 0 ok / 1 infinity / -1 malformed / -2 not on curve /
 * -3 not in subgroup.  out_x/out_y are 32 int32 device limbs. */
int lodestar_bls_g1_decompress(const uint8_t in[48], int32_t out_x[32],
                               int32_t out_y[32], int check_subgroup) {
  memset(out_x, 0, 32 * sizeof(int32_t));
  memset(out_y, 0, 32 * sizeof(int32_t));
  g1p p;
  int rc = g1_parse_compressed(in, &p);
  if (rc != 0) return rc;
  if (check_subgroup && !g1_in_subgroup(&p)) return -3;
  fp_to_limbs12(out_x, p.X);
  fp_to_limbs12(out_y, p.Y);
  return 0;
}

/* parse a compressed G2 point to affine Montgomery coordinates.
 * Returns 0 ok / 1 infinity / -1 malformed / -2 off-curve / -3 subgroup. */
static int g2_parse_compressed_aff(const uint8_t in[96], fp2 *x, fp2 *y,
                                   int check_subgroup) {
  uint8_t flags = in[0];
  if (!(flags & FLAG_C)) return -1;
  if (flags & FLAG_I) {
    if (flags != (FLAG_C | FLAG_I)) return -1;
    for (int i = 1; i < 96; i++)
      if (in[i]) return -1;
    return 1;
  }
  uint8_t buf[48];
  memcpy(buf, in, 48);
  buf[0] &= 0x1F;
  uint64_t x1w[6], x0w[6];
  if (!fp_from_be(x1w, buf)) return -1;       /* first 48B: c1 (ZCash order) */
  if (!fp_from_be(x0w, in + 48)) return -1;   /* second 48B: c0 */
  fp2 y2, t;
  fp_to_mont(x->c0, x0w);
  fp_to_mont(x->c1, x1w);
  fp2_sqr(&t, x);
  fp2_mul(&t, &t, x);
  fp2 b2;
  memcpy(&b2, BLS_B2_M, sizeof(fp2));
  fp2_add(&y2, &t, &b2);
  if (!fp2_sqrt(y, &y2)) return -2;
  if (fp2_lex_larger(y) != !!(flags & FLAG_S)) fp2_neg(y, y);
  if (check_subgroup) {
    g2p p;
    fp2_copy(&p.X, x);
    fp2_copy(&p.Y, y);
    fp2_one(&p.Z);
    if (!g2_in_subgroup(&p)) return -3;
  }
  return 0;
}

int lodestar_bls_g2_decompress(const uint8_t in[96], int32_t out_x[64],
                               int32_t out_y[64], int check_subgroup) {
  memset(out_x, 0, 64 * sizeof(int32_t));
  memset(out_y, 0, 64 * sizeof(int32_t));
  fp2 x, y;
  int rc = g2_parse_compressed_aff(in, &x, &y, check_subgroup);
  if (rc != 0) return rc;
  fp_to_limbs12(out_x, x.c0);
  fp_to_limbs12(out_x + 32, x.c1);
  fp_to_limbs12(out_y, y.c0);
  fp_to_limbs12(out_y + 32, y.c1);
  return 0;
}

/* ---------------- hash to curve (G2) ---------------- */

/* RFC 9380 5.3.1 expand_message_xmd, SHA-256, len fixed to 256 bytes
 * (count=2 draws x m=2 coords x L=64). msg arbitrary length. */
static void expand_message_xmd_256(const uint8_t *msg, size_t msg_len,
                                   const uint8_t *dst, size_t dst_len,
                                   uint8_t out[256]) {
  uint8_t dst_prime[256];
  size_t dpl = dst_len;
  memcpy(dst_prime, dst, dst_len);
  dst_prime[dpl++] = (uint8_t)dst_len;

  uint8_t b0[32], bi[32];
  /* b0 = H(Z_pad || msg || l_i_b_str || 0 || dst'); one-shot SHA over a
   * stack buffer — callers cap msg at 3KB (consensus messages are 32B). */
  {
    uint8_t big[4096];
    size_t off = 0;
    memset(big, 0, 64);
    off = 64;
    memcpy(big + off, msg, msg_len);
    off += msg_len;
    big[off++] = 1; /* l_i_b_str hi: 256 = 0x0100 */
    big[off++] = 0;
    big[off++] = 0;
    memcpy(big + off, dst_prime, dpl);
    off += dpl;
    lodestar_sha256(big, off, b0);
  }
  uint8_t cur[32 + 1 + 256];
  memcpy(cur, b0, 32);
  cur[32] = 1;
  memcpy(cur + 33, dst_prime, dpl);
  lodestar_sha256(cur, 33 + dpl, bi);
  memcpy(out, bi, 32);
  for (int i = 2; i <= 8; i++) {
    for (int j = 0; j < 32; j++) cur[j] = b0[j] ^ bi[j];
    cur[32] = (uint8_t)i;
    memcpy(cur + 33, dst_prime, dpl);
    lodestar_sha256(cur, 33 + dpl, bi);
    memcpy(out + (i - 1) * 32, bi, 32);
  }
}

/* 64 big-endian bytes -> field element (Montgomery), reduced mod p. */
static void fp_from_be64_mod(fp r, const uint8_t in[64]) {
  /* value = a1*2^384 + a0, a1 = top 16 bytes, a0 = bottom 48 bytes */
  uint64_t a1[6] = {0}, a0[6];
  for (int i = 0; i < 2; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[(1 - i) * 8 + j];
    a1[i] = w;
  }
  for (int i = 0; i < 6; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[16 + (5 - i) * 8 + j];
    a0[i] = w;
  }
  fp m1, m0;
  fp_mul(m1, a1, BLS_R2);       /* a1 * R  (valid: a1 < R) */
  fp_mul(m1, m1, BLS_R2);       /* a1 * R * R = (a1*2^384)*R mod p */
  fp_mul(m0, a0, BLS_R2);       /* a0 * R */
  fp_add(r, m1, m0);
}

/* simplified SWU onto E2' (RFC 9380 6.6.2), then 3-isogeny to E2. */
static void map_to_curve_g2(g2p *out, const fp2 *u) {
  fp2 A, B, Z, nba, bza;
  memcpy(&A, BLS_SSWU_A, sizeof(fp2));
  memcpy(&B, BLS_SSWU_B, sizeof(fp2));
  memcpy(&Z, BLS_SSWU_Z, sizeof(fp2));
  memcpy(&nba, BLS_SSWU_NBA, sizeof(fp2));
  memcpy(&bza, BLS_SSWU_BZA, sizeof(fp2));

  fp2 u2, zu2, tv, x1, gx1, y, x, one;
  fp2_sqr(&u2, u);
  fp2_mul(&zu2, &Z, &u2);
  fp2_sqr(&tv, &zu2);
  fp2_add(&tv, &tv, &zu2);            /* Z^2 u^4 + Z u^2 */
  if (fp2_is_zero(&tv)) {
    fp2_copy(&x1, &bza);              /* B/(Z*A) */
  } else {
    fp2 ti;
    fp2_inv(&ti, &tv);
    fp2_one(&one);
    fp2_add(&ti, &ti, &one);
    fp2_mul(&x1, &nba, &ti);          /* -B/A * (1 + 1/tv) */
  }
  fp2 t;
  fp2_sqr(&t, &x1);
  fp2_mul(&t, &t, &x1);
  fp2 ax;
  fp2_mul(&ax, &A, &x1);
  fp2_add(&t, &t, &ax);
  fp2_add(&gx1, &t, &B);
  if (fp2_sqrt(&y, &gx1)) {
    fp2_copy(&x, &x1);
  } else {
    fp2 x2, gx2;
    fp2_mul(&x2, &zu2, &x1);
    fp2_sqr(&t, &x2);
    fp2_mul(&t, &t, &x2);
    fp2_mul(&ax, &A, &x2);
    fp2_add(&t, &t, &ax);
    fp2_add(&gx2, &t, &B);
    fp2_sqrt(&y, &gx2);               /* must succeed */
    fp2_copy(&x, &x2);
  }
  if (fp2_sgn0(&y) != fp2_sgn0(u)) fp2_neg(&y, &y);

  /* 3-isogeny (Velu form): X(x) = x + t/(x-x0) + u/(x-x0)^2, then the
   * scaling isomorphism (x,y) -> (x/l^2, y/l^3). */
  fp2 x0c, tc, uc, d, di, di2, di3, xx, dx, two_u, yy;
  memcpy(&x0c, BLS_ISO_X0, sizeof(fp2));
  memcpy(&tc, BLS_ISO_T, sizeof(fp2));
  memcpy(&uc, BLS_ISO_U, sizeof(fp2));
  fp2_sub(&d, &x, &x0c);
  fp2_inv(&di, &d);
  fp2_sqr(&di2, &di);
  fp2_mul(&di3, &di2, &di);
  fp2 term;
  fp2_mul(&term, &tc, &di);
  fp2_add(&xx, &x, &term);
  fp2_mul(&term, &uc, &di2);
  fp2_add(&xx, &xx, &term);
  fp2_one(&one);
  fp2_mul(&term, &tc, &di2);
  fp2_sub(&dx, &one, &term);
  fp2_add(&two_u, &uc, &uc);
  fp2_mul(&term, &two_u, &di3);
  fp2_sub(&dx, &dx, &term);
  fp2_mul(&yy, &y, &dx);
  fp2_mul_fp(&xx, &xx, BLS_ISO_IL2);
  fp2_mul_fp(&yy, &yy, BLS_ISO_IL3);

  fp2_copy(&out->X, &xx);
  fp2_copy(&out->Y, &yy);
  fp2_one(&out->Z);
}

/* hash-to-curve returning affine Montgomery coordinates. */
static int hash_to_g2_aff(const uint8_t *msg, size_t msg_len,
                          const uint8_t *dst, size_t dst_len, fp2 *x, fp2 *y) {
  if (msg_len > 3000 || dst_len == 0 || dst_len > 255) return -1;
  uint8_t uniform[256];
  expand_message_xmd_256(msg, msg_len, dst, dst_len, uniform);
  fp2 u0, u1;
  fp_from_be64_mod(u0.c0, uniform);
  fp_from_be64_mod(u0.c1, uniform + 64);
  fp_from_be64_mod(u1.c0, uniform + 128);
  fp_from_be64_mod(u1.c1, uniform + 192);
  g2p q0, q1, q;
  map_to_curve_g2(&q0, &u0);
  map_to_curve_g2(&q1, &u1);
  g2_add(&q, &q0, &q1);
  g2_clear_cofactor(&q, &q);
  if (g2_is_infinity(&q)) return -2;  /* astronomically unlikely */
  g2_to_affine(x, y, &q);
  return 0;
}

int lodestar_bls_hash_to_g2(const uint8_t *msg, size_t msg_len,
                            const uint8_t *dst, size_t dst_len,
                            int32_t out_x[64], int32_t out_y[64]) {
  fp2 x, y;
  int rc = hash_to_g2_aff(msg, msg_len, dst, dst_len, &x, &y);
  if (rc != 0) return rc;
  fp_to_limbs12(out_x, x.c0);
  fp_to_limbs12(out_x + 32, x.c1);
  fp_to_limbs12(out_y, y.c0);
  fp_to_limbs12(out_y + 32, y.c1);
  return 0;
}

/* ---------------- pairing (optimal ate, host tier) ----------------
 *
 * The CPU verification fallback: without this the only non-device verify
 * path was the Python big-int oracle — any device outage
 * or the individual-retry path under attack traffic would collapse the
 * node.  Tower Fp2[v]/(v^3 - xi), xi = 1+u, then Fp6[w]/(w^2 - v) —
 * the same tower as the device tier (ops/fp6, ops/fp12) and the oracle
 * (bls/fields), so the Frobenius gamma tables are shared via
 * gen_bls12_consts.py.  Reference analog: blst's C pairing behind
 * verifyMultipleSignatures (chain/bls/maybeBatch.ts).
 */

typedef struct { fp2 c0, c1, c2; } fp6;
typedef struct { fp6 c0, c1; } fp12;

static void fp2_mul_xi(fp2 *r, const fp2 *a) {
  /* (1+u)(a0 + a1 u) = (a0 - a1) + (a0 + a1) u */
  fp t0, t1;
  fp_sub(t0, a->c0, a->c1);
  fp_add(t1, a->c0, a->c1);
  fp_copy(r->c0, t0);
  fp_copy(r->c1, t1);
}

static void fp6_add(fp6 *r, const fp6 *a, const fp6 *b) {
  fp2_add(&r->c0, &a->c0, &b->c0);
  fp2_add(&r->c1, &a->c1, &b->c1);
  fp2_add(&r->c2, &a->c2, &b->c2);
}
static void fp6_sub(fp6 *r, const fp6 *a, const fp6 *b) {
  fp2_sub(&r->c0, &a->c0, &b->c0);
  fp2_sub(&r->c1, &a->c1, &b->c1);
  fp2_sub(&r->c2, &a->c2, &b->c2);
}
static void fp6_neg(fp6 *r, const fp6 *a) {
  fp2_neg(&r->c0, &a->c0);
  fp2_neg(&r->c1, &a->c1);
  fp2_neg(&r->c2, &a->c2);
}
static void fp6_zero(fp6 *r) { fp2_zero(&r->c0); fp2_zero(&r->c1); fp2_zero(&r->c2); }
static void fp6_one(fp6 *r) { fp2_one(&r->c0); fp2_zero(&r->c1); fp2_zero(&r->c2); }
static int fp6_is_zero(const fp6 *a) {
  return fp2_is_zero(&a->c0) && fp2_is_zero(&a->c1) && fp2_is_zero(&a->c2);
}

static void fp6_mul(fp6 *r, const fp6 *a, const fp6 *b) {
  /* schoolbook with v^3 = xi */
  fp2 v0, v1, v2, t, s;
  fp2_mul(&v0, &a->c0, &b->c0);
  fp2_mul(&v1, &a->c1, &b->c1);
  fp2_mul(&v2, &a->c2, &b->c2);
  fp6 out;
  /* c0 = v0 + xi((a1+a2)(b1+b2) - v1 - v2) */
  fp2 a12, b12;
  fp2_add(&a12, &a->c1, &a->c2);
  fp2_add(&b12, &b->c1, &b->c2);
  fp2_mul(&t, &a12, &b12);
  fp2_sub(&t, &t, &v1);
  fp2_sub(&t, &t, &v2);
  fp2_mul_xi(&t, &t);
  fp2_add(&out.c0, &v0, &t);
  /* c1 = (a0+a1)(b0+b1) - v0 - v1 + xi v2 */
  fp2_add(&a12, &a->c0, &a->c1);
  fp2_add(&b12, &b->c0, &b->c1);
  fp2_mul(&t, &a12, &b12);
  fp2_sub(&t, &t, &v0);
  fp2_sub(&t, &t, &v1);
  fp2_mul_xi(&s, &v2);
  fp2_add(&out.c1, &t, &s);
  /* c2 = (a0+a2)(b0+b2) - v0 - v2 + v1 */
  fp2_add(&a12, &a->c0, &a->c2);
  fp2_add(&b12, &b->c0, &b->c2);
  fp2_mul(&t, &a12, &b12);
  fp2_sub(&t, &t, &v0);
  fp2_sub(&t, &t, &v2);
  fp2_add(&out.c2, &t, &v1);
  *r = out;
}
static void fp6_sqr(fp6 *r, const fp6 *a) { fp6_mul(r, a, a); }

static void fp6_mul_by_v(fp6 *r, const fp6 *a) {
  /* v(c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2 */
  fp2 t;
  fp2_mul_xi(&t, &a->c2);
  fp2 c0 = a->c0, c1 = a->c1;
  fp2_copy(&r->c0, &t);
  fp2_copy(&r->c1, &c0);
  fp2_copy(&r->c2, &c1);
}

static void fp6_inv(fp6 *r, const fp6 *a) {
  /* standard: c0 = a0^2 - xi a1 a2, c1 = xi a2^2 - a0 a1,
   * c2 = a1^2 - a0 a2; t = a0 c0 + xi(a2 c1 + a1 c2); r = c_i / t */
  fp2 c0, c1, c2, t, s;
  fp2_sqr(&c0, &a->c0);
  fp2_mul(&t, &a->c1, &a->c2);
  fp2_mul_xi(&t, &t);
  fp2_sub(&c0, &c0, &t);
  fp2_sqr(&c1, &a->c2);
  fp2_mul_xi(&c1, &c1);
  fp2_mul(&t, &a->c0, &a->c1);
  fp2_sub(&c1, &c1, &t);
  fp2_sqr(&c2, &a->c1);
  fp2_mul(&t, &a->c0, &a->c2);
  fp2_sub(&c2, &c2, &t);
  fp2_mul(&t, &a->c0, &c0);
  fp2_mul(&s, &a->c2, &c1);
  fp2 s2;
  fp2_mul(&s2, &a->c1, &c2);
  fp2_add(&s, &s, &s2);
  fp2_mul_xi(&s, &s);
  fp2_add(&t, &t, &s);
  fp2 tinv;
  fp2_inv(&tinv, &t);
  fp2_mul(&r->c0, &c0, &tinv);
  fp2_mul(&r->c1, &c1, &tinv);
  fp2_mul(&r->c2, &c2, &tinv);
}

static void fp12_one(fp12 *r) { fp6_one(&r->c0); fp6_zero(&r->c1); }
static void fp12_conj(fp12 *r, const fp12 *a) {
  r->c0 = a->c0;
  fp6_neg(&r->c1, &a->c1);
}
static int fp12_is_one(const fp12 *a) {
  fp2 one;
  fp2_one(&one);
  return fp2_eq(&a->c0.c0, &one) && fp2_is_zero(&a->c0.c1) &&
         fp2_is_zero(&a->c0.c2) && fp6_is_zero(&a->c1);
}

static void fp12_mul(fp12 *r, const fp12 *a, const fp12 *b) {
  fp6 v0, v1, t, s;
  fp6_mul(&v0, &a->c0, &b->c0);
  fp6_mul(&v1, &a->c1, &b->c1);
  fp6_add(&t, &a->c0, &a->c1);
  fp6_add(&s, &b->c0, &b->c1);
  fp6_mul(&t, &t, &s);           /* (a0+a1)(b0+b1) */
  fp6_sub(&t, &t, &v0);
  fp6_sub(&t, &t, &v1);          /* c1 */
  fp6_mul_by_v(&s, &v1);
  fp6_add(&r->c0, &v0, &s);
  r->c1 = t;
}
static void fp12_sqr(fp12 *r, const fp12 *a) {
  /* complex squaring: c0 = (a0+a1)(a0+v a1) - v0 - v v0, c1 = 2 v0 */
  fp6 v0, t0, t1;
  fp6_mul(&v0, &a->c0, &a->c1);
  fp6_add(&t0, &a->c0, &a->c1);
  fp6_mul_by_v(&t1, &a->c1);
  fp6_add(&t1, &a->c0, &t1);
  fp6_mul(&t0, &t0, &t1);        /* (a0+a1)(a0 + v a1) */
  fp6_sub(&t0, &t0, &v0);
  fp6_mul_by_v(&t1, &v0);
  fp6_sub(&r->c0, &t0, &t1);
  fp6_add(&r->c1, &v0, &v0);
}

static void fp12_inv(fp12 *r, const fp12 *a) {
  /* (c0 - c1 w) / (c0^2 - v c1^2) */
  fp6 t0, t1;
  fp6_sqr(&t0, &a->c0);
  fp6_sqr(&t1, &a->c1);
  fp6_mul_by_v(&t1, &t1);
  fp6_sub(&t0, &t0, &t1);
  fp6_inv(&t0, &t0);
  fp6_mul(&r->c0, &a->c0, &t0);
  fp6_mul(&t1, &a->c1, &t0);
  fp6_neg(&r->c1, &t1);
}

/* sparse line multiply: f *= l0 + l1 w^2 + l2 w^3, i.e. in the fp6 pair
 * view A = (l0, l1, 0), B = (0, l2, 0) with f' = (f0 A + v f1 B,
 * (f0+f1)(A+B) - f0 A - f1 B)  [same layout as device ops/fp12.mul_by_line] */
static void fp6_mul_sparse01(fp6 *r, const fp6 *f, const fp2 *a0, const fp2 *a1) {
  /* f * (a0 + a1 v) */
  fp2 t0, t1, t2, s;
  fp6 out;
  fp2_mul(&t0, &f->c0, a0);
  fp2_mul(&t1, &f->c2, a1);
  fp2_mul_xi(&s, &t1);
  fp2_add(&out.c0, &t0, &s);
  fp2_mul(&t0, &f->c0, a1);
  fp2_mul(&t1, &f->c1, a0);
  fp2_add(&out.c1, &t0, &t1);
  fp2_mul(&t1, &f->c1, a1);
  fp2_mul(&t2, &f->c2, a0);
  fp2_add(&out.c2, &t1, &t2);
  *r = out;
}
static void fp6_mul_sparse1(fp6 *r, const fp6 *f, const fp2 *b1) {
  /* f * (b1 v) */
  fp2 t;
  fp6 out;
  fp2_mul(&t, &f->c2, b1);
  fp2_mul_xi(&out.c0, &t);
  fp2_mul(&out.c1, &f->c0, b1);
  fp2_mul(&out.c2, &f->c1, b1);
  *r = out;
}
static void fp12_mul_by_line(fp12 *f, const fp2 *l0, const fp2 *l1,
                             const fp2 *l2) {
  fp6 t0, t1, t2, g;
  fp2 s;
  fp6_mul_sparse01(&t0, &f->c0, l0, l1);     /* f0 * A */
  fp6_mul_sparse1(&t1, &f->c1, l2);          /* f1 * B */
  fp6_add(&g, &f->c0, &f->c1);
  fp2_add(&s, l1, l2);
  fp6_mul_sparse01(&t2, &g, l0, &s);         /* (f0+f1)(A+B) */
  fp6 vt1;
  fp6_mul_by_v(&vt1, &t1);
  fp6_add(&f->c0, &t0, &vt1);
  fp6_sub(&t2, &t2, &t0);
  fp6_sub(&f->c1, &t2, &t1);
}

/* Frobenius x^(p^k), k = 1..3, via the shared gamma tables: w-coefficient
 * view d = (c00, c10, c01, c11, c02, c12), conj each for odd k, then
 * d_i *= gamma_k[i] (same construction as device ops/fp12.frobenius). */
static void fp12_frobenius(fp12 *r, const fp12 *a, int k) {
  const uint64_t (*gam)[2][6] =
      k == 1 ? BLS_FROB_G1 : (k == 2 ? BLS_FROB_G2 : BLS_FROB_G3);
  const fp2 *d[6] = {&a->c0.c0, &a->c1.c0, &a->c0.c1,
                     &a->c1.c1, &a->c0.c2, &a->c1.c2};
  fp2 *o[6] = {&r->c0.c0, &r->c1.c0, &r->c0.c1,
               &r->c1.c1, &r->c0.c2, &r->c1.c2};
  for (int i = 0; i < 6; i++) {
    fp2 t;
    if (k & 1) fp2_conj(&t, d[i]);
    else fp2_copy(&t, d[i]);
    fp2 g;
    memcpy(&g, gam[i], sizeof(fp2));
    fp2_mul(o[i], &t, &g);
  }
}

/* Granger–Scott cyclotomic squaring (valid after the easy part) — the
 * same three-Fp4 formulas as device ops/fp12.cyclotomic_square. */
static void fp12_cyclotomic_sqr(fp12 *r, const fp12 *g) {
  const fp2 *a = &g->c0.c0, *b = &g->c0.c1, *c = &g->c0.c2;
  const fp2 *d = &g->c1.c0, *e = &g->c1.c1, *f = &g->c1.c2;
  fp2 a2, e2, c2, d2, b2, f2, t, t0, t2, t4, t6, t7, t8;
  fp2_sqr(&a2, a); fp2_sqr(&e2, e); fp2_sqr(&c2, c);
  fp2_sqr(&d2, d); fp2_sqr(&b2, b); fp2_sqr(&f2, f);
  /* t6 = 2ae, t7 = 2cd, t8 = 2bf*xi via (x+y)^2 - x^2 - y^2 */
  fp2_add(&t, a, e); fp2_sqr(&t, &t); fp2_sub(&t, &t, &a2); fp2_sub(&t6, &t, &e2);
  fp2_add(&t, c, d); fp2_sqr(&t, &t); fp2_sub(&t, &t, &c2); fp2_sub(&t7, &t, &d2);
  fp2_add(&t, b, f); fp2_sqr(&t, &t); fp2_sub(&t, &t, &b2); fp2_sub(&t, &t, &f2);
  fp2_mul_xi(&t8, &t);
  fp2_mul_xi(&t, &e2); fp2_add(&t0, &t, &a2);     /* t0 = a^2 + xi e^2 */
  fp2_mul_xi(&t, &c2); fp2_add(&t2, &t, &d2);     /* t2 = d^2 + xi c^2 */
  fp2_mul_xi(&t, &f2); fp2_add(&t4, &t, &b2);     /* t4 = b^2 + xi f^2 */
  fp12 out;
  /* c0' = (3t0 - 2a, 3t2 - 2b, 3t4 - 2c); c1' = (3t8+2d, 3t6+2e, 3t7+2f) */
  fp2 y;
#define GS_MINUS(dst, tv, xv)                                                  \
  do {                                                                         \
    fp2_sub(&y, &(tv), (xv));                                                  \
    fp2_add(&y, &y, &y);                                                       \
    fp2_add(&(dst), &y, &(tv));                                                \
  } while (0)
#define GS_PLUS(dst, tv, xv)                                                   \
  do {                                                                         \
    fp2_add(&y, &(tv), (xv));                                                  \
    fp2_add(&y, &y, &y);                                                       \
    fp2_add(&(dst), &y, &(tv));                                                \
  } while (0)
  GS_MINUS(out.c0.c0, t0, a);
  GS_MINUS(out.c0.c1, t2, b);
  GS_MINUS(out.c0.c2, t4, c);
  GS_PLUS(out.c1.c0, t8, d);
  GS_PLUS(out.c1.c1, t6, e);
  GS_PLUS(out.c1.c2, t7, f);
#undef GS_MINUS
#undef GS_PLUS
  *r = out;
}

/* line + double / line + add on homogeneous projective T (ported 1:1 from
 * device ops/pairing._line_and_double/_line_and_add, affine-P variant). */
static void pair_line_dbl(fp2 *l0, fp2 *l1, fp2 *l2, g2p *t,
                          const fp xp_neg, const fp yp) {
  fp2 xx, yy, zz, yz, xy, xxx, yyz, xxz, yzz, t2b, b2;
  memcpy(&b2, BLS_B2_M, sizeof(fp2));
  fp2 b3;
  fp2_add(&b3, &b2, &b2);
  fp2_add(&b3, &b3, &b2);
  fp2_sqr(&xx, &t->X);
  fp2_sqr(&yy, &t->Y);
  fp2_sqr(&zz, &t->Z);
  fp2_mul(&yz, &t->Y, &t->Z);
  fp2_mul(&xy, &t->X, &t->Y);
  fp2_mul(&xxx, &xx, &t->X);
  fp2_mul(&yyz, &yy, &t->Z);
  fp2_mul(&xxz, &xx, &t->Z);
  fp2_mul(&yzz, &yz, &t->Z);
  fp2_mul(&t2b, &b3, &zz);
  /* l0 = 3X^3 - 2Y^2 Z */
  fp2 s;
  fp2_add(l0, &xxx, &xxx);
  fp2_add(l0, l0, &xxx);
  fp2_add(&s, &yyz, &yyz);
  fp2_sub(l0, l0, &s);
  /* l1 = 3X^2 Z * (-xp),  l2 = 2YZ^2 * yp */
  fp2 three_xxz, two_yzz;
  fp2_add(&three_xxz, &xxz, &xxz);
  fp2_add(&three_xxz, &three_xxz, &xxz);
  fp2_mul_fp(l1, &three_xxz, xp_neg);
  fp2_add(&two_yzz, &yzz, &yzz);
  fp2_mul_fp(l2, &two_yzz, yp);
  /* double (RCB16 alg 9): */
  fp2 z8, y3s, t0c;
  fp2_add(&z8, &yy, &yy);
  fp2_add(&z8, &z8, &z8);
  fp2_add(&z8, &z8, &z8);                 /* 8Y^2 */
  fp2_add(&y3s, &yy, &t2b);
  fp2_add(&s, &t2b, &t2b);
  fp2_add(&s, &s, &t2b);
  fp2_sub(&t0c, &yy, &s);                 /* Y^2 - 3 b3 Z^2 */
  fp2 x3, z3, y3m, xt;
  fp2_mul(&x3, &t2b, &z8);
  fp2_mul(&z3, &yz, &z8);
  fp2_mul(&y3m, &t0c, &y3s);
  fp2_mul(&xt, &t0c, &xy);
  fp2_add(&t->X, &xt, &xt);
  fp2_add(&t->Y, &x3, &y3m);
  fp2_copy(&t->Z, &z3);
}

static void pair_line_add(fp2 *l0, fp2 *l1, fp2 *l2, g2p *t,
                          const fp2 *xq, const fp2 *yq, const fp xp_neg,
                          const fp yp) {
  fp2 b2, b3;
  memcpy(&b2, BLS_B2_M, sizeof(fp2));
  fp2_add(&b3, &b2, &b2);
  fp2_add(&b3, &b3, &b2);
  fp2 t0, t1, u, xqz, yqz, b3z, s;
  fp2_mul(&t0, &t->X, xq);
  fp2_mul(&t1, &t->Y, yq);
  fp2_add(&u, &t->X, &t->Y);
  fp2_add(&s, xq, yq);
  fp2_mul(&u, &u, &s);                       /* (X+Y)(xq+yq) */
  fp2_mul(&xqz, xq, &t->Z);
  fp2_mul(&yqz, yq, &t->Z);
  fp2_mul(&b3z, &b3, &t->Z);
  fp2 theta, h;
  fp2_sub(&theta, &t->Y, &yqz);              /* Y - yq Z */
  fp2_sub(&h, &t->X, &xqz);                  /* X - xq Z */
  /* lines: l0 = theta xq - yq h, l1 = theta(-xp), l2 = h yp */
  fp2 thxq, yqh;
  fp2_mul(&thxq, &theta, xq);
  fp2_mul(&yqh, yq, &h);
  fp2_sub(l0, &thxq, &yqh);
  fp2_mul_fp(l1, &theta, xp_neg);
  fp2_mul_fp(l2, &h, yp);
  /* mixed addition (RCB16 alg 8) */
  fp2 t3, y3p, t4, x3, z3, t1m, y3;
  fp2_sub(&t3, &u, &t0);
  fp2_sub(&t3, &t3, &t1);                    /* xy cross */
  fp2_add(&y3p, &xqz, &t->X);
  fp2_add(&t4, &yqz, &t->Y);
  fp2_add(&x3, &t0, &t0);
  fp2_add(&x3, &x3, &t0);                    /* 3 X xq */
  fp2_add(&z3, &t1, &b3z);
  fp2_sub(&t1m, &t1, &b3z);
  fp2_mul(&y3, &b3, &y3p);
  fp2 a_, b_, c_, d_, e_, f_;
  fp2_mul(&a_, &t3, &t1m);
  fp2_mul(&b_, &t4, &y3);
  fp2_mul(&c_, &y3, &x3);
  fp2_mul(&d_, &t1m, &z3);
  fp2_mul(&e_, &z3, &t4);
  fp2_mul(&f_, &x3, &t3);
  fp2_sub(&t->X, &a_, &b_);
  fp2_add(&t->Y, &c_, &d_);
  fp2_add(&t->Z, &e_, &f_);
}

/* f = conj(f_{|x|,Q}(P)) for P = (xp, yp) affine G1, Q affine G2 —
 * same convention as the oracle/device tiers. */
static void miller_loop_c(fp12 *f, const fp xp, const fp yp, const fp2 *xq,
                          const fp2 *yq) {
  fp xp_neg;
  fp_neg(xp_neg, xp);
  g2p t;
  fp2_copy(&t.X, xq);
  fp2_copy(&t.Y, yq);
  fp2_one(&t.Z);
  fp12_one(f);
  uint64_t x_abs = BLS_X_ABS[0];
  int top = 63;
  while (!((x_abs >> top) & 1)) top--;
  fp2 l0, l1, l2;
  for (int i = top - 1; i >= 0; i--) {
    fp12_sqr(f, f);
    pair_line_dbl(&l0, &l1, &l2, &t, xp_neg, yp);
    fp12_mul_by_line(f, &l0, &l1, &l2);
    if ((x_abs >> i) & 1) {
      pair_line_add(&l0, &l1, &l2, &t, xq, yq, xp_neg, yp);
      fp12_mul_by_line(f, &l0, &l1, &l2);
    }
  }
  fp12_conj(f, f);  /* x < 0 */
}

static void fp12_pow_x_abs(fp12 *r, const fp12 *g) {
  /* g^|x| with cyclotomic squarings (g is in the cyclotomic subgroup) */
  fp12 acc = *g;
  uint64_t x_abs = BLS_X_ABS[0];
  int top = 63;
  while (!((x_abs >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    fp12_cyclotomic_sqr(&acc, &acc);
    if ((x_abs >> i) & 1) fp12_mul(&acc, &acc, g);
  }
  *r = acc;
}
static void fp12_pow_x(fp12 *r, const fp12 *g) {
  fp12_pow_x_abs(r, g);
  fp12_conj(r, r);  /* x negative */
}

/* final exponentiation — easy part then the HHT hard part; computes
 * pairing^3 exactly like the oracle/device (harmless for ==1 checks). */
static void final_exp_c(fp12 *r, const fp12 *f_in) {
  fp12 f, t;
  fp12_conj(&f, f_in);
  fp12_inv(&t, f_in);
  fp12_mul(&f, &f, &t);            /* f^(p^6 - 1) */
  fp12_frobenius(&t, &f, 2);
  fp12_mul(&f, &t, &f);            /* ^(p^2 + 1): cyclotomic now */
  /* a = pxm1(pxm1(f)), pxm1(g) = g^x * conj(g) */
  fp12 a, b, c, s;
  fp12_pow_x(&a, &f);
  fp12_conj(&t, &f);
  fp12_mul(&a, &a, &t);
  fp12_pow_x(&s, &a);
  fp12_conj(&t, &a);
  fp12_mul(&a, &s, &t);
  /* b = a^x * frob1(a) */
  fp12_pow_x(&b, &a);
  fp12_frobenius(&t, &a, 1);
  fp12_mul(&b, &b, &t);
  /* c = b^(x^2) * frob2(b) * conj(b) */
  fp12_pow_x(&c, &b);
  fp12_pow_x(&c, &c);
  fp12_frobenius(&t, &b, 2);
  fp12_mul(&c, &c, &t);
  fp12_conj(&t, &b);
  fp12_mul(&c, &c, &t);
  /* result = c * f^3 */
  fp12_sqr(&t, &f);
  fp12_mul(&t, &t, &f);
  fp12_mul(r, &c, &t);
}

/* dual Miller loop: f = conj(f_{|x|,Q1}(P1) * f_{|x|,Q2}(P2)) — ONE
 * shared fp12 squaring chain for both pairs (the squarings dominate;
 * a multi-pairing halves them vs two separate loops). */
static void miller_loop2_c(fp12 *f, const fp p1x, const fp p1y,
                           const fp2 *q1x, const fp2 *q1y, const fp p2x,
                           const fp p2y, const fp2 *q2x, const fp2 *q2y) {
  fp p1x_neg, p2x_neg;
  fp_neg(p1x_neg, p1x);
  fp_neg(p2x_neg, p2x);
  g2p t1, t2;
  fp2_copy(&t1.X, q1x); fp2_copy(&t1.Y, q1y); fp2_one(&t1.Z);
  fp2_copy(&t2.X, q2x); fp2_copy(&t2.Y, q2y); fp2_one(&t2.Z);
  fp12_one(f);
  uint64_t x_abs = BLS_X_ABS[0];
  int top = 63;
  while (!((x_abs >> top) & 1)) top--;
  fp2 l0, l1, l2;
  for (int i = top - 1; i >= 0; i--) {
    fp12_sqr(f, f);
    pair_line_dbl(&l0, &l1, &l2, &t1, p1x_neg, p1y);
    fp12_mul_by_line(f, &l0, &l1, &l2);
    pair_line_dbl(&l0, &l1, &l2, &t2, p2x_neg, p2y);
    fp12_mul_by_line(f, &l0, &l1, &l2);
    if ((x_abs >> i) & 1) {
      pair_line_add(&l0, &l1, &l2, &t1, q1x, q1y, p1x_neg, p1y);
      fp12_mul_by_line(f, &l0, &l1, &l2);
      pair_line_add(&l0, &l1, &l2, &t2, q2x, q2y, p2x_neg, p2y);
      fp12_mul_by_line(f, &l0, &l1, &l2);
    }
  }
  fp12_conj(f, f);  /* x < 0 */
}

/* one signature set: e(pk, H(m)) * e(-g1, sig) == 1 */
static int pairing_verify_one(const fp pk_x, const fp pk_y, const fp2 *h_x,
                              const fp2 *h_y, const fp2 *sig_x,
                              const fp2 *sig_y) {
  fp12 f;
  fp g1x, g1y_neg, gy;
  memcpy(g1x, BLS_G1_GX, sizeof(fp));
  memcpy(gy, BLS_G1_GY, sizeof(fp));
  fp_neg(g1y_neg, gy);
  miller_loop2_c(&f, pk_x, pk_y, h_x, h_y, g1x, g1y_neg, sig_x, sig_y);
  final_exp_c(&f, &f);
  return fp12_is_one(&f);
}

/* reassemble a field element from 32x12-bit device limbs (they carry the
 * Montgomery form directly — fp_to_limbs12 is the inverse). */
static void fp_from_limbs12(fp r, const int32_t in[32]) {
  uint64_t w[8];
  memset(w, 0, sizeof(w));
  for (int i = 0; i < 32; i++) {
    uint64_t v = (uint64_t)(uint32_t)in[i] & 0xFFF;
    int bit = 12 * i;
    w[bit / 64] |= v << (bit % 64);
    if ((bit % 64) > 52) w[bit / 64 + 1] |= v >> (64 - bit % 64);
  }
  memcpy(r, w, sizeof(fp));
}

/* Verify n signature sets on the CPU (pubkey 48B, 32B signing root,
 * signature 96B per set); out_ok[i] = 1 iff set i verifies.  The
 * production fallback/oracle tier (reference: blst verify in
 * chain/bls/maybeBatch.ts).  h_x/h_y non-NULL: per-set hash-to-curve device
 * limbs from the caller's signing-root cache (gossip shares roots, so
 * hashing dominates otherwise); msgs/msg_lens may then be NULL. */
int lodestar_bls_verify_sets(size_t n, const uint8_t *pks,
                             const uint8_t *msgs, const size_t *msg_lens,
                             const uint8_t *sigs, const uint8_t *dst,
                             size_t dst_len, const int32_t *h_x,
                             const int32_t *h_y, uint8_t *out_ok) {
  size_t msg_off = 0;
  for (size_t i = 0; i < n; i++) {
    out_ok[i] = 0;
    /* set i's message starts here whether or not set i gets as far as
       hashing it: a set refused earlier must not shift its successors' */
    const uint8_t *msg = msgs + msg_off;
    size_t msg_len = msg_lens[i];
    msg_off += msg_len;
    g1p pk;
    int rc = g1_parse_compressed(pks + 48 * i, &pk);
    if (rc != 0) continue;                 /* infinity pk invalid (KeyValidate) */
    if (!g1_in_subgroup(&pk)) continue;
    fp2 sx, sy;
    rc = g2_parse_compressed_aff(sigs + 96 * i, &sx, &sy, 1);
    if (rc != 0) continue;                 /* infinity sig never verifies */
    fp2 hx, hy;
    if (h_x != NULL && h_y != NULL) {
      fp_from_limbs12(hx.c0, h_x + 64 * i);
      fp_from_limbs12(hx.c1, h_x + 64 * i + 32);
      fp_from_limbs12(hy.c0, h_y + 64 * i);
      fp_from_limbs12(hy.c1, h_y + 64 * i + 32);
    } else {
      if (hash_to_g2_aff(msg, msg_len, dst, dst_len, &hx, &hy) != 0) continue;
    }
    fp pkx, pky;
    g1_to_affine(pkx, pky, &pk);
    out_ok[i] = (uint8_t)pairing_verify_one(pkx, pky, &hx, &hy, &sx, &sy);
  }
  return 0;
}

/* AggregateVerify: key i signed message i, and one signature covers all
 * n of them: prod_i e(pk_i, H(m_i)) * e(-g1, sig) == 1, one Miller loop
 * per pair and one final exponentiation.  Returns 1 valid / 0 not: no
 * pair, an infinity, malformed or off-subgroup key or signature, or a
 * message hash-to-curve refuses, is 0. */
int lodestar_bls_aggregate_verify(size_t n, const uint8_t *pks,
                                  const uint8_t *msgs, const size_t *msg_lens,
                                  const uint8_t *sig, const uint8_t *dst,
                                  size_t dst_len) {
  if (n == 0) return 0;
  fp2 sx, sy;
  if (g2_parse_compressed_aff(sig, &sx, &sy, 1) != 0) return 0;
  fp g1x, g1y_neg, gy;
  memcpy(g1x, BLS_G1_GX, sizeof(fp));
  memcpy(gy, BLS_G1_GY, sizeof(fp));
  fp_neg(g1y_neg, gy);
  fp12 acc, f;
  miller_loop_c(&acc, g1x, g1y_neg, &sx, &sy);
  size_t msg_off = 0;
  for (size_t i = 0; i < n; i++) {
    g1p pk;
    if (g1_parse_compressed(pks + 48 * i, &pk) != 0) return 0;
    if (!g1_in_subgroup(&pk)) return 0;
    fp2 hx, hy;
    if (hash_to_g2_aff(msgs + msg_off, msg_lens[i], dst, dst_len, &hx, &hy) != 0)
      return 0;
    msg_off += msg_lens[i];
    fp pkx, pky;
    g1_to_affine(pkx, pky, &pk);
    miller_loop_c(&f, pkx, pky, &hx, &hy);
    fp12_mul(&acc, &acc, &f);
  }
  final_exp_c(&acc, &acc);
  return fp12_is_one(&acc);
}

/* ---------------- signing ----------------
 *
 * sign = [sk]·H(m): the host-tier signer, in place of the Python
 * oracle's G2 scalar multiplication and hash. */

static void fp_to_be48(uint8_t out[48], const uint64_t w[6]) {
  for (int i = 0; i < 6; i++)
    for (int b = 0; b < 8; b++)
      out[48 - 8 * i - 1 - b] = (uint8_t)(w[i] >> (8 * b));
}

/* ZCash compression: 48 B big-endian x with the C, I and S flags in
 * byte 0; infinity is C|I and zeros. */
static void g1_compress(uint8_t out[48], const g1p *p) {
  if (g1_is_infinity(p)) {
    memset(out, 0, 48);
    out[0] = FLAG_C | FLAG_I;
    return;
  }
  fp x, y;
  g1_to_affine(x, y, p);
  uint64_t w[6];
  fp_from_mont(w, x);
  fp_to_be48(out, w);
  out[0] |= FLAG_C;
  if (fp_lex_larger(y)) out[0] |= FLAG_S;
}

/* 96 B: c1 (flags in byte 0) then c0, both big-endian. */
static void g2_compress(uint8_t out[96], const g2p *p) {
  if (g2_is_infinity(p)) {
    memset(out, 0, 96);
    out[0] = FLAG_C | FLAG_I;
    return;
  }
  fp2 x, y;
  g2_to_affine(&x, &y, p);
  uint64_t w[6];
  fp_from_mont(w, x.c1);
  fp_to_be48(out, w);
  fp_from_mont(w, x.c0);
  fp_to_be48(out + 48, w);
  out[0] |= FLAG_C;
  if (fp2_lex_larger(&y)) out[0] |= FLAG_S;
}

int lodestar_bls_sign(const uint8_t sk_be[32], const uint8_t *msg,
                      size_t msg_len, const uint8_t *dst, size_t dst_len,
                      uint8_t out[96]) {
  uint64_t k[4];
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int b = 0; b < 8; b++) v = (v << 8) | sk_be[8 * i + b];
    k[3 - i] = v;
  }
  /* 0 < sk < r */
  int all_zero = !(k[0] | k[1] | k[2] | k[3]);
  if (all_zero || fp_cmp_ge(k, BLS_ORDER_R, 4)) return -1;
  fp2 hx, hy;
  int rc = hash_to_g2_aff(msg, msg_len, dst, dst_len, &hx, &hy);
  if (rc != 0) return rc;
  g2p h, s;
  fp2_copy(&h.X, &hx);
  fp2_copy(&h.Y, &hy);
  fp2_one(&h.Z);
  g2_scalar_mul(&s, &h, k, 4);
  if (g2_is_infinity(&s)) return -2;  /* impossible for valid sk */
  g2_compress(out, &s);
  return 0;
}

/* Public key of a secret key: [sk]·g1, ZCash-compressed (48 B).  Returns
 * 0 ok / -1 when sk is not in (0, r).  Test and benchmark data only: the
 * ladder is variable-time. */
int lodestar_bls_sk_to_pk(const uint8_t sk_be[32], uint8_t out[48]) {
  uint64_t k[4];
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int b = 0; b < 8; b++) v = (v << 8) | sk_be[8 * i + b];
    k[3 - i] = v;
  }
  if (!(k[0] | k[1] | k[2] | k[3]) || fp_cmp_ge(k, BLS_ORDER_R, 4)) return -1;
  g1p g, s;
  fp_copy(g.X, BLS_G1_GX);
  fp_copy(g.Y, BLS_G1_GY);
  fp_copy(g.Z, BLS_ONE_M);
  g1_scalar_mul(&s, &g, k, 4);
  g1_compress(out, &s);
  return 0;
}

/* ---------------- aggregation ---------------- */

/* Aggregate n compressed G1 pubkeys -> the compressed sum (48 B; the
 * infinity encoding when the sum is infinity).  Returns 0 ok / 1
 * aggregate-is-infinity / -1 malformed / -2 off-curve / -3 subgroup.
 * Infinity pubkeys contribute nothing (callers reject them upstream at
 * KeyValidate). */
int lodestar_bls_g1_aggregate(const uint8_t *pks, size_t n, int check_each,
                              uint8_t out[48]) {
  g1p acc;
  g1_infinity(&acc);
  for (size_t i = 0; i < n; i++) {
    g1p p;
    int rc = g1_parse_compressed(pks + 48 * i, &p);
    if (rc == 1) continue;
    if (rc != 0) return rc;
    if (check_each && !g1_in_subgroup(&p)) return -3;
    g1_add(&acc, &acc, &p);
  }
  g1_compress(out, &acc);
  return g1_is_infinity(&acc) ? 1 : 0;
}

/* Aggregate n compressed G2 signatures -> the compressed sum (96 B).
 * Same return codes as lodestar_bls_g1_aggregate; check_each runs each
 * signature's subgroup check. */
int lodestar_bls_g2_aggregate(const uint8_t *sigs, size_t n, int check_each,
                              uint8_t out[96]) {
  g2p acc;
  g2_infinity(&acc);
  for (size_t i = 0; i < n; i++) {
    g2p p;
    int rc = g2_parse_compressed_aff(sigs + 96 * i, &p.X, &p.Y, check_each);
    if (rc == 1) continue;
    if (rc != 0) return rc;
    fp2_one(&p.Z);
    g2_add(&acc, &acc, &p);
  }
  g2_compress(out, &acc);
  return g2_is_infinity(&acc) ? 1 : 0;
}

/* ---------------- batched set marshalling ----------------
 *
 * For n signature sets (pubkey 48B, message 32B signing root, signature
 * 96B) fill the device arrays pk_x/pk_y (n,32), msg_x/msg_y/sig_x/sig_y
 * (n,64) and ok (n bytes).  A set that fails decompression/subgroup or has
 * an infinity pubkey/signature gets ok=0 and zeroed lanes (the reference
 * rejects those sets: maybeBatch.ts catching blst errors).
 */
int lodestar_bls_marshal_sets(size_t n, const uint8_t *pks, const uint8_t *msgs,
                              const uint8_t *sigs, const uint8_t *dst,
                              size_t dst_len, int check_pk_subgroup,
                              int check_sig_subgroup, int do_hash, int do_pk,
                              int32_t *pk_x, int32_t *pk_y, int32_t *msg_x,
                              int32_t *msg_y, int32_t *sig_x, int32_t *sig_y,
                              uint8_t *ok) {
  /* do_hash=0: caller fills msg_x/msg_y itself (e.g. from a
   * hash-to-curve cache — gossip shares signing roots across a whole
   * committee, so per-set hashing is mostly redundant work).
   * do_pk=0: caller fills pk_x/pk_y from its pubkey-limb cache (the
   * reference's pubkey cache deserializes each validator key once —
   * attesters repeat every epoch, so the per-set G1 sqrt is redundant
   * steady-state work). */
  if (!do_pk) {
    memset(pk_x, 0, n * 32 * sizeof(int32_t));
    memset(pk_y, 0, n * 32 * sizeof(int32_t));
  }
  for (size_t i = 0; i < n; i++) {
    ok[i] = 0;
    if (do_pk) {
      int rcp = lodestar_bls_g1_decompress(pks + 48 * i, pk_x + 32 * i,
                                           pk_y + 32 * i, check_pk_subgroup);
      if (rcp != 0) continue; /* infinity pubkey is invalid per Eth2 */
    }
    int rc = lodestar_bls_g2_decompress(sigs + 96 * i, sig_x + 64 * i,
                                        sig_y + 64 * i, check_sig_subgroup);
    if (rc != 0) continue;
    if (do_hash) {
      rc = lodestar_bls_hash_to_g2(msgs + 32 * i, 32, dst, dst_len,
                                   msg_x + 64 * i, msg_y + 64 * i);
      if (rc != 0) continue;
    }
    ok[i] = 1;
  }
  return 0;
}
