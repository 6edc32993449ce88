/* Poseidon permutation over the BN254 scalar field, t=5, x^5 S-box,
 * 8 full + 60 partial rounds (circomlib parameterization), on the packed
 * 12-u64 Goldilocks state: the host permutation of the
 * PoseidonBN128GoldilocksConfig (reference: plonky2/build.rs:63-88 links
 * the Go library libposeidon-permute-c.a; hash/poseidon_bn128.rs:60-100
 * permute FFI).
 *
 * Field arithmetic: 4x64-bit limbs, Montgomery form (R = 2^256), CIOS
 * multiplication with unsigned __int128. Round constants and the MDS
 * matrix arrive pre-converted to Montgomery form in the generated header
 * bn128_constants_gen.h, which plonky2_tpu_torch/host.py emits from the
 * port's hash/poseidon_bn128.py Grain derivation (held to the reference's
 * known answers by the tests).
 *
 * The batch entries (permute_many, hash_leaves, compress_many) split their
 * rows into contiguous ranges over `threads` pthreads; each row is
 * independent, so the output does not depend on the thread count.
 */

#include <pthread.h>
#include <stddef.h>
#include <stdint.h>

#include "bn128_constants_gen.h"

typedef uint64_t u64;
typedef unsigned __int128 u128;

#define T 5
#define RF 8
#define RP 60

/* ---- 4-limb field element, little-endian ------------------------------- */

static inline int fe_geq(const u64 *a, const u64 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline void fe_sub_p(u64 *a) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - P_LIMBS[i] - (u64)borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;  /* 1 if borrowed */
    }
}

static inline void fe_add(const u64 *a, const u64 *b, u64 *c) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a[i] + b[i] + (u64)carry;
        c[i] = (u64)s;
        carry = s >> 64;
    }
    /* a, b < p < 2^254 so no limb-4 overflow; reduce once */
    if (fe_geq(c, P_LIMBS)) fe_sub_p(c);
}

/* CIOS Montgomery multiplication: out = a*b*R^-1 mod p */
static void fe_mul(const u64 *a, const u64 *b, u64 *out) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)a[j] * b[i] + (u64)c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s = (u128)t[4] + (u64)c;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * P_INV;
        c = ((u128)t[0] + (u128)m * P_LIMBS[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            s = (u128)t[j] + (u128)m * P_LIMBS[j] + (u64)c;
            t[j - 1] = (u64)s;
            c = s >> 64;
        }
        s = (u128)t[4] + (u64)c;
        t[3] = (u64)s;
        t[4] = t[5] + (u64)(s >> 64);
    }
    out[0] = t[0]; out[1] = t[1]; out[2] = t[2]; out[3] = t[3];
    if (t[4] || fe_geq(out, P_LIMBS)) fe_sub_p(out);
}

static inline void fe_pow5(const u64 *x, u64 *out) {
    u64 x2[4], x4[4];
    fe_mul(x, x, x2);
    fe_mul(x2, x2, x4);
    fe_mul(x4, x, out);
}

/* ---- the t=5 permutation (state in Montgomery form) -------------------- */

static void permute_fe(u64 s[T][4]) {
    u64 ns[T][4], tmp[4];
    for (int r = 0; r < RF + RP; r++) {
        for (int i = 0; i < T; i++)
            fe_add(s[i], RC_MONT[r * T + i], s[i]);
        if (r < RF / 2 || r >= RF / 2 + RP) {
            for (int i = 0; i < T; i++) fe_pow5(s[i], s[i]);
        } else {
            fe_pow5(s[0], s[0]);
        }
        for (int i = 0; i < T; i++) {
            fe_mul(MDS_MONT[i * T + 0], s[0], ns[i]);
            for (int j = 1; j < T; j++) {
                fe_mul(MDS_MONT[i * T + j], s[j], tmp);
                fe_add(ns[i], tmp, ns[i]);
            }
        }
        for (int i = 0; i < T; i++)
            for (int k = 0; k < 4; k++) s[i][k] = ns[i][k];
    }
}

#define GOLDILOCKS 0xFFFFFFFF00000001ULL

/* 12 Goldilocks u64 -> 12 Goldilocks u64 (pack 3 u64 per 192-bit scalar,
 * permute, unpack first 4 scalars; reference: poseidon_bn128.rs:80-140) */
void bn128_permute(u64 st[12]) {
    u64 s[T][4];
    /* state[0] = 0 */
    for (int k = 0; k < 4; k++) s[0][k] = 0;
    for (int i = 0; i < 4; i++) {
        u64 norm[4] = {st[3 * i + 2], st[3 * i + 1], st[3 * i], 0};
        fe_mul(norm, R2_LIMBS, s[1 + i]);      /* to Montgomery */
    }
    permute_fe(s);
    static const u64 one[4] = {1, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u64 norm[4];
        fe_mul(s[i], one, norm);               /* from Montgomery */
        u64 limbs[3] = {norm[2], norm[1], norm[0]};  /* bits 128.., 64.., 0.. */
        for (int j = 0; j < 3; j++) {
            u64 v = limbs[j];
            if (v >= GOLDILOCKS) v -= GOLDILOCKS;
            st[3 * i + j] = v;
        }
    }
}

/* overwrite-mode sponge, rate 8: hash n inputs to 4 outputs */
void bn128_hash_no_pad(const u64 *in, size_t n, u64 out[4]) {
    u64 st[12] = {0};
    for (size_t start = 0; start < n; start += 8) {
        size_t len = n - start < 8 ? n - start : 8;
        for (size_t i = 0; i < len; i++) {
            u64 v = in[start + i];
            if (v >= GOLDILOCKS) v -= GOLDILOCKS;
            st[i] = v;
        }
        bn128_permute(st);
    }
    for (int i = 0; i < 4; i++) out[i] = st[i];
}

/* hash_or_noop of rows [lo, hi) of [n_rows, row_len] -> [n_rows, 4]
 * (rows of <= 4 elements pack directly; reference config.rs:74-88) */
static void hash_leaves_rows(const u64 *in, size_t row_len, u64 *out,
                             size_t lo, size_t hi) {
    for (size_t r = lo; r < hi; r++) {
        const u64 *row = in + r * row_len;
        u64 *o = out + r * 4;
        if (row_len <= 4) {
            for (size_t i = 0; i < 4; i++) {
                u64 v = i < row_len ? row[i] : 0;
                if (v >= GOLDILOCKS) v -= GOLDILOCKS;
                o[i] = v;
            }
        } else {
            bn128_hash_no_pad(row, row_len, o);
        }
    }
}

/* two_to_one of digest pairs [lo, hi): left [n,4] + right [n,4] -> [n,4] */
static void compress_rows(const u64 *left, const u64 *right, u64 *out,
                          size_t lo, size_t hi) {
    u64 buf[8];
    for (size_t r = lo; r < hi; r++) {
        for (int i = 0; i < 4; i++) buf[i] = left[r * 4 + i];
        for (int i = 0; i < 4; i++) buf[4 + i] = right[r * 4 + i];
        bn128_hash_no_pad(buf, 8, out + r * 4);
    }
}

/* ---- rows split over threads ------------------------------------------ */

enum { HASH_LEAVES, COMPRESS, PERMUTE };

typedef struct {
    int kind;
    const u64 *a, *b;
    u64 *out;
    size_t row_len, lo, hi;
} job_t;

static void *run_job(void *arg) {
    job_t *j = (job_t *)arg;
    if (j->kind == HASH_LEAVES) {
        hash_leaves_rows(j->a, j->row_len, j->out, j->lo, j->hi);
    } else if (j->kind == COMPRESS) {
        compress_rows(j->a, j->b, j->out, j->lo, j->hi);
    } else {
        for (size_t r = j->lo; r < j->hi; r++) bn128_permute(j->out + r * 12);
    }
    return NULL;
}

#define MAX_THREADS 256

/* Rows [0, n) in `threads` contiguous ranges, the first on the calling
 * thread; a range whose thread cannot be started runs there too. */
static void run_rows(job_t job, size_t n, int threads) {
    if (threads < 1) threads = 1;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    if ((size_t)threads > n) threads = n ? (int)n : 1;
    job_t jobs[MAX_THREADS];
    pthread_t tids[MAX_THREADS];
    int started[MAX_THREADS];
    for (int t = 0; t < threads; t++) {
        jobs[t] = job;
        jobs[t].lo = n * t / threads;
        jobs[t].hi = n * (t + 1) / threads;
        started[t] = t > 0 && pthread_create(&tids[t], NULL, run_job,
                                             &jobs[t]) == 0;
    }
    for (int t = 0; t < threads; t++)
        if (!started[t]) run_job(&jobs[t]);
    for (int t = 1; t < threads; t++)
        if (started[t]) pthread_join(tids[t], NULL);
}

void bn128_hash_leaves(const u64 *in, size_t n_rows, size_t row_len,
                       u64 *out, int threads) {
    job_t job = {HASH_LEAVES, in, NULL, out, row_len, 0, 0};
    run_rows(job, n_rows, threads);
}

void bn128_compress_many(const u64 *left, const u64 *right, size_t n,
                         u64 *out, int threads) {
    job_t job = {COMPRESS, left, right, out, 0, 0, 0};
    run_rows(job, n, threads);
}

/* the permutation of each of n states [n, 12], in place (the PoW grind) */
void bn128_permute_many(u64 *states, size_t n, int threads) {
    job_t job = {PERMUTE, NULL, NULL, states, 0, 0, 0};
    run_rows(job, n, threads);
}
