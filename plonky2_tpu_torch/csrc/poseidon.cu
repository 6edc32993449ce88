// K2 and K3: the Poseidon width-12 permutation over Goldilocks, the fused
// leaf sponge and the Merkle tree above the leaves.
//
// K2 `poseidon_permute` and `poseidon_merkle_tree` replace
// plonky2_tpu/ops/pallas_poseidon.py `_permute_fn_soa_v3` (:335): the first
// permutes any batch of states (the FRI PoW wave), the second builds every
// layer of a Merkle tree above its leaf digests in at most two launches. K3
// `poseidon_hash_leaves` replaces `_leaf_hash_fn_pallas` (:410), the
// overwrite-mode sponge hash_no_pad over each leaf column.
//
// Bound: operations. 472 general 64-bit field multiplies per permutation
// (the x^7 S-boxes of 8 full rounds x 12 and 22 partial rounds x 1) against
// 96 bytes of state in and out, L x 8 bytes of leaf in and 32 out, or 32
// bytes of digest in and out for each tree node.
//
// Design:
// - One permutation device function, `permute`, for every entry: the
//   reference permutation in its fast-partial-round form, one thread per
//   state, the state in registers. Measured against the plain schedule
//   (an MDS layer in every partial round): 0.97 against 1.16 ms at 2^19
//   states (PERF.md).
// - Goldilocks arithmetic on 32-bit limbs with PTX carry chains: a product
//   is four partial products, and the 128-bit result is reduced through the
//   carry flag with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), with no compares
//   or selects. Values stay anywhere in [0, 2^64) between operations (every
//   multiply and reduction takes any 64-bit operands), and are made
//   canonical once, where a state or digest leaves the kernel. The MDS
//   constants are below 2^6, so an MDS row sums the 32-bit halves of the
//   state times its constants with `mad.wide.u32` into two 64-bit
//   accumulators, which the next round's constants start, and reduces once.
//   Sums of general products (the w_hat row, the initial matrix) accumulate
//   the 128-bit products in 160 bits and reduce once.
// - The round loops are rolled, the round constants read from __constant__
//   memory at a uniform address. The fully unrolled permutation was 28k
//   SASS instructions (440 KB), far past the instruction cache, and ran
//   11-75% slower.
// - The permutation takes 242 registers, so two blocks of 128 threads fit
//   on an SM; the grid is sized to that, each thread looping over its share
//   of the batch in whole waves. Code that took fewer registers and ran 16
//   warps on an SM was slower (PERF.md).
// - K3: one thread per leaf column, reading column i with thread i, so a
//   warp reads consecutive addresses; the next chunk of eight elements is
//   loaded before the current permutation runs.
// - The tree: a block builds a subtree of up to 2^10 leaves in shared
//   memory, level by level, writing every node into one buffer at fixed
//   offsets (layer l at row N - N / 2^(l-1)); at most 2^7 such blocks, so
//   the card holds them at once, then one block takes their roots down to
//   the cap. The upper levels have too few permutations to fill the card,
//   so their time is one permutation's latency: those levels spread each
//   permutation over 16 lanes (`permute_lanes`), which cuts it to about a
//   third.

#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_tables.h"

namespace {

constexpr int W = 12;
constexpr int RATE = 8;
constexpr int DIGEST = 4;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr uint64_t P = 0xFFFFFFFF00000001ULL;

// ---------------------------------------------------------------------------
// Goldilocks on values anywhere in [0, 2^64)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t pack(uint32_t lo, uint32_t hi) {
  uint64_t r;
  asm("mov.b64 %0, {%1, %2};" : "=l"(r) : "r"(lo), "r"(hi));
  return r;
}

// The 128-bit product a b = r[0] + r[1] 2^32 + r[2] 2^64 + r[3] 2^96.
__device__ __forceinline__ void mul_wide(uint64_t a, uint64_t b,
                                         uint32_t r[4]) {
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %4;\n\t"
      "mov.b64 {b0, b1}, %5;\n\t"
      "mul.lo.u32 %0, a0, b0;\n\t"
      "mul.hi.u32 %1, a0, b0;\n\t"
      "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
      "madc.hi.u32 %2, a0, b1, 0;\n\t"
      "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
      "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
      "madc.hi.u32 %3, a1, b1, 0;\n\t"
      "mad.lo.cc.u32 %2, a1, b1, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "l"(a), "l"(b));
}

// r0 + r1 2^32 + r2 2^64 + r3 2^96 mod p; the result is < 2^64, not always
// < p.
__device__ __forceinline__ uint64_t reduce128(uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3) {
  uint32_t t0, t1;
  asm("{\n\t"
      ".reg .u32 w0, w1, m;\n\t"
      // 2^96 = -1: t = lo - r3; on a borrow t came out 2^64 = 2^32 - 1 too
      // high, and t >= 2^64 - 2^32 + 1, so taking 2^32 - 1 off cannot borrow
      "sub.cc.u32 %0, %2, %5;\n\t"
      "subc.cc.u32 %1, %3, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      // 2^64 = 2^32 - 1: t + r2 (2^32 - 1) = t + (r2 2^32 - r2); on a carry
      // add 2^32 - 1 back, which cannot carry again
      "sub.cc.u32 w0, 0, %4;\n\t"
      "subc.u32 w1, %4, 0;\n\t"
      "add.cc.u32 %0, %0, w0;\n\t"
      "addc.cc.u32 %1, %1, w1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=&r"(t0), "=&r"(t1)
      : "r"(r0), "r"(r1), "r"(r2), "r"(r3));
  return pack(t0, t1);
}

// a * b mod p for any a, b < 2^64; the result is < 2^64.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint32_t r[4];
  mul_wide(a, b, r);
  return reduce128(r[0], r[1], r[2], r[3]);
}

// (L + H 2^32) mod p for L < 2^64 and H < 2^64 - 2^32; the result is < 2^64.
__device__ __forceinline__ uint64_t reduce_lh(uint64_t L, uint64_t H) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 l0, l1, h0, h1, w0, w1, c;\n\t"
      "mov.b64 {l0, l1}, %2;\n\t"
      "mov.b64 {h0, h1}, %3;\n\t"
      // L + H 2^32 = l0 + (l1 + h0) 2^32 + h1' 2^64
      "add.cc.u32 %1, l1, h0;\n\t"
      "addc.u32 h1, h1, 0;\n\t"
      // + h1' (2^32 - 1); on a carry add 2^32 - 1 back (cannot carry again)
      "sub.cc.u32 w0, 0, h1;\n\t"
      "subc.u32 w1, h1, 0;\n\t"
      "add.cc.u32 %0, l0, w0;\n\t"
      "addc.cc.u32 %1, %1, w1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "l"(L), "l"(H));
  return pack(r0, r1);
}

// a + c mod p for a < 2^64 and c < p; the result is < 2^64.
__device__ __forceinline__ uint64_t add_canon(uint64_t a, uint64_t c) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 a0, a1, c0, c1, m;\n\t"
      "mov.b64 {a0, a1}, %2;\n\t"
      "mov.b64 {c0, c1}, %3;\n\t"
      "add.cc.u32 %0, a0, c0;\n\t"
      "addc.cc.u32 %1, a1, c1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "l"(a), "l"(c));
  return pack(r0, r1);
}

__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= P ? x - P : x;
}

__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b,
                                             uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// ---------------------------------------------------------------------------
// The permutation
// ---------------------------------------------------------------------------

// x^7 as x^4 x^3: three multiplies deep
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul(x, x);
  const uint64_t x3 = mul(x2, x);
  const uint64_t x4 = mul(x2, x2);
  return mul(x4, x3);
}

// s <- MDS s + rc, rc canonical. Row r sums C_MDS[r][c] (< 2^6, at most 264
// over a row) times the 32-bit halves of s[c]: each half-sum stays below
// 2^42, and the row reduces once.
__device__ __forceinline__ void mds_add(uint64_t s[W], const uint64_t* rc) {
  uint32_t lo[W], hi[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    lo[c] = (uint32_t)s[c];
    hi[c] = (uint32_t)(s[c] >> 32);
  }
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const uint64_t k = rc[r];
    uint64_t L = k & 0xFFFFFFFFULL, H = k >> 32;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      L = mad_wide(lo[c], C_MDS[r * W + c], L);
      H = mad_wide(hi[c], C_MDS[r * W + c], H);
    }
    s[r] = reduce_lh(L, H);
  }
}

// acc (160 bits, 5 limbs) += a b
__device__ __forceinline__ void mac(uint32_t acc[5], uint64_t a, uint64_t b) {
  uint32_t p[4];
  mul_wide(a, b, p);
  asm("add.cc.u32 %0, %0, %5;\n\t"
      "addc.cc.u32 %1, %1, %6;\n\t"
      "addc.cc.u32 %2, %2, %7;\n\t"
      "addc.cc.u32 %3, %3, %8;\n\t"
      "addc.u32 %4, %4, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]));
}

// acc mod p for acc[4] < 2^31, with 2^128 = -2^32 (mod p): x - acc[4] 2^32;
// on a borrow x came out 2^64 = 2^32 - 1 too high, and is then above
// 2^64 - 2^63, so taking 2^32 - 1 off cannot borrow
__device__ __forceinline__ uint64_t reduce160(const uint32_t acc[5]) {
  const uint64_t x = reduce128(acc[0], acc[1], acc[2], acc[3]);
  uint32_t t0, t1;
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "mov.b64 {%0, %1}, %2;\n\t"
      "sub.cc.u32 %1, %1, %3;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "}"
      : "=&r"(t0), "=&r"(t1)
      : "l"(x), "r"(acc[4]));
  return pack(t0, t1);
}

// c + a b mod p for any a, b, c < 2^64
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b,
                                            uint64_t c) {
  uint32_t p[4];
  mul_wide(a, b, p);
  asm("{\n\t"
      ".reg .u32 c0, c1;\n\t"
      "mov.b64 {c0, c1}, %4;\n\t"
      "add.cc.u32 %0, %0, c0;\n\t"
      "addc.cc.u32 %1, %1, c1;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "}"
      : "+r"(p[0]), "+r"(p[1]), "+r"(p[2]), "+r"(p[3])
      : "l"(c));
  return reduce128(p[0], p[1], p[2], p[3]);
}

// The partial rounds of the fast-partial-round form, after full round 3
// has added C_FIRST_RC: the 11 x 11 initial matrix, then 22 rounds on the
// sparse factors of the MDS (an S-box on s[0], then s[0] <- the w_hat row
// and s[i] += v[i] s[0]), then round 26's constants.
__device__ __forceinline__ void partial_rounds(uint64_t s[W]) {
  uint64_t t[W - 1];
#pragma unroll
  for (int c = 0; c < W - 1; ++c) {
    uint32_t acc[5] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < W - 1; ++k)
      mac(acc, s[k + 1], C_INIT_MAT[k * (W - 1) + c]);
    t[c] = reduce160(acc);
  }
#pragma unroll
  for (int c = 0; c < W - 1; ++c) s[c + 1] = t[c];
#pragma unroll 1
  for (int k = 0; k < PARTIAL; ++k) {
    // the last partial round adds no constant (its table entry is 0)
    const uint64_t s0 = add_canon(sbox(s[0]), C_PARTIAL_RC[k]);
    uint32_t acc[5] = {0, 0, 0, 0, 0};
    mac(acc, s0, C_MDS[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) {
      mac(acc, s[i], C_W_HATS[k * (W - 1) + i - 1]);
      s[i] = mul_add(s0, C_VS[k * (W - 1) + i - 1], s[i]);
    }
    s[0] = reduce160(acc);
  }
#pragma unroll
  for (int i = 0; i < W; ++i)
    s[i] = add_canon(s[i], C_RC[W * (HALF_FULL + PARTIAL) + i]);
}

__device__ __forceinline__ void full_round(uint64_t s[W], int r) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = sbox(s[i]);
  mds_add(s, C_FULL_RC + W * r);
}

// The reference permutation in its fast-partial-round form (poseidon.rs
// `poseidon`; the tables of poseidon_fast.py): full rounds 0-3, the partial
// rounds, full rounds 26-29, each in a rolled loop. C_FULL_RC[r] holds the
// constants added after the r-th full round (the next round's, C_FIRST_RC
// after round 3, zeros after the last). One loop over all eight full rounds
// with the partial rounds inside it made smaller code (5.5k against 7.0k
// SASS instructions) but ran 5% slower at 2^19 states and 15% slower per
// permutation alone (PERF.md).
__device__ __forceinline__ void permute(uint64_t s[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = add_canon(s[i], C_RC[i]);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
  partial_rounds(s);
#pragma unroll 1
  for (int r = HALF_FULL; r < 2 * HALF_FULL; ++r) full_round(s, r);
}

// The same permutation spread over the 16 lanes of a group, lane l < 12
// holding s[l] and `row` its MDS row (lanes 12-15 compute what is ignored),
// in the plain schedule: the full MDS in every round, one S-box on lane 0 in
// a partial round. Every lane of the warp calls it. A round costs one S-box,
// 24 shuffles and one MDS row per lane: a permutation's latency is about a
// third of `permute`'s (a tree level of 16 permutations 16 against 42 us on
// the H100), for about three times its lane-instructions, so it serves the
// tree levels that have too few permutations to fill the card.
__device__ __forceinline__ uint64_t permute_lanes(uint64_t x, int l,
                                                  const uint32_t row[W]) {
  const int li = l < W ? l : 0;
  x = add_canon(x, C_RC[li]);
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    if (r < HALF_FULL || r >= HALF_FULL + PARTIAL || l == 0) x = sbox(x);
    const uint64_t k = C_RC[W * (r + 1) + li];
    uint64_t L = k & 0xFFFFFFFFULL, H = k >> 32;
    const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
#pragma unroll
    for (int c = 0; c < W; ++c) {
      L = mad_wide(__shfl_sync(0xFFFFFFFFu, lo, c, 16), row[c], L);
      H = mad_wide(__shfl_sync(0xFFFFFFFFu, hi, c, 16), row[c], H);
    }
    x = reduce_lh(L, H);
  }
  return x;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    permute_kernel(const uint64_t* __restrict__ in,
                   uint64_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < n; b += stride) {
    uint64_t s[W];
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = in[b * W + i];
    permute(s);
#pragma unroll
    for (int i = 0; i < W; ++i) out[b * W + i] = canonical(s[i]);
  }
}

__global__ void __launch_bounds__(THREADS)
    hash_leaves_kernel(const uint64_t* __restrict__ x,
                       uint64_t* __restrict__ out, int L, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       col < n; col += stride) {
    uint64_t s[W], next[RATE];
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = 0;
#pragma unroll
    for (int k = 0; k < RATE; ++k)
      if (k < L) next[k] = __ldg(x + (long long)k * n + col);
    for (int start = 0; start < L; start += RATE) {
      const int len = L - start < RATE ? L - start : RATE;
#pragma unroll
      for (int k = 0; k < RATE; ++k)
        if (k < len) s[k] = next[k];
      // the next chunk's loads are in flight while this one is permuted
      const int nlen = L - start - RATE;
#pragma unroll
      for (int k = 0; k < RATE; ++k)
        if (k < nlen) next[k] = __ldg(x + (long long)(start + RATE + k) * n +
                                      col);
      permute(s);
    }
#pragma unroll
    for (int k = 0; k < DIGEST; ++k) out[col * DIGEST + k] = canonical(s[k]);
  }
}

// Offset, in digests, of tree layer `level` (>= 1) in the buffer of a tree
// with n leaves: layers 1, 2, ... are stored one after another.
__device__ __forceinline__ long long layer_offset(long long n, int level) {
  return n - (n >> (level - 1));
}

constexpr int TREE_THREADS = 256;
constexpr int LANES = 16;               // a lane group holds one state
constexpr int TREE_LG_ONE_BLOCK = 10;   // at most 2^10 inputs in a block
constexpr int TREE_LG_TOP = 7;          // the last launch takes 2^7 roots

// Block b takes inputs [b 2^lg_in, (b + 1) 2^lg_in) of layer `level0` (the
// leaves for 0) and builds `levels` layers above them in shared memory, two
// buffers used in turn, writing each node to its place in `out`. A level
// whose permutations fill at most two passes of the block's lane groups
// runs them on `permute_lanes`; a larger one runs one permutation per
// thread on `permute`.
__global__ void __launch_bounds__(TREE_THREADS)
    merkle_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  long long n_leaves, int level0, int lg_in, int levels) {
  extern __shared__ uint64_t node[];   // [2^lg_in + 2^(lg_in-1)][4]
  uint64_t* src = node;
  uint64_t* nxt = node + (DIGEST << lg_in);
  const int t = threadIdx.x, lane = t % LANES;
  const long long first = (long long)blockIdx.x << lg_in;
  for (int i = t; i < DIGEST << lg_in; i += blockDim.x)
    src[i] = in[first * DIGEST + i];
  uint32_t row[W];
#pragma unroll
  for (int c = 0; c < W; ++c) row[c] = C_MDS[(lane < W ? lane : 0) * W + c];
  __syncthreads();
  for (int j = 1; j <= levels; ++j) {
    const int m = 1 << (lg_in - j);     // permutations at this level
    uint64_t* dst = out + DIGEST * (layer_offset(n_leaves, level0 + j) +
                                    ((long long)blockIdx.x << (lg_in - j)));
    const int groups = blockDim.x / LANES;
    if (m <= 2 * groups) {
      const int passes = (m + groups - 1) / groups;
      for (int g = t / LANES; g < passes * groups; g += groups) {
        const bool live = g < m;
        uint64_t x = live && lane < 2 * DIGEST ? src[2 * DIGEST * g + lane]
                                               : 0;
        x = permute_lanes(x, lane, row);
        if (live && lane < DIGEST) {
          x = canonical(x);
          nxt[DIGEST * g + lane] = x;
          dst[DIGEST * g + lane] = x;
        }
      }
    } else {
      for (int p = t; p < m; p += blockDim.x) {
        uint64_t s[W];
#pragma unroll
        for (int i = 0; i < 2 * DIGEST; ++i) s[i] = src[2 * DIGEST * p + i];
#pragma unroll
        for (int i = 2 * DIGEST; i < W; ++i) s[i] = 0;
        permute(s);
#pragma unroll
        for (int i = 0; i < DIGEST; ++i) {
          const uint64_t v = canonical(s[i]);
          nxt[DIGEST * p + i] = v;
          dst[DIGEST * p + i] = v;
        }
      }
    }
    uint64_t* tmp = src;
    src = nxt;
    nxt = tmp;
    __syncthreads();
  }
}

// Blocks for n threads of THREADS: the resident slots of the card are
// filled in whole waves, so that no wave runs part-empty. *slots caches the
// kernel's resident threads on the card.
// Resident blocks of THREADS on each SM at the permutation's 242 registers.
constexpr int BLOCKS_PER_SM = 2;

// Blocks for n threads of THREADS: BLOCKS_PER_SM on each SM at most, each
// thread looping over its share, in whole waves of the resident threads so
// that no wave runs part-empty.
unsigned grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long slots = (long long)sms * BLOCKS_PER_SM * THREADS;
  const long long waves = (n + slots - 1) / slots;
  return (unsigned)((n + waves * THREADS - 1) / (waves * THREADS));
}

}  // namespace

// states_in, states_out: [n, 12] contiguous; any n.
extern "C" int poseidon_permute(const void* states_in, void* states_out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = grid_for(n);
  permute_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(states_in),
      static_cast<uint64_t*>(states_out), n);
  return (int)cudaGetLastError();
}

// x: [L, n] contiguous (column i is leaf i); out: [n, 4] digests of the
// overwrite-mode sponge hash_no_pad over each column.
extern "C" int poseidon_hash_leaves(const void* x, void* out, int L,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = grid_for(n);
  hash_leaves_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out), L, n);
  return (int)cudaGetLastError();
}

// leaves: [n, 4] digests, n a power of two; out: [n - 2^cap_height, 4], the
// layers above the leaves down to the cap, layer l at row
// n - n / 2^(l-1). Subtrees of up to 2^10 leaves, at most 2^7 of them (one
// block each, which the card holds at once), then one block from their
// roots to the cap: two launches up to 2^17 leaves, one up to 2^7. Writes
// the number of kernels launched to *launches.
extern "C" int poseidon_merkle_tree(const void* leaves, void* out,
                                    long long n, int cap_height,
                                    void* stream, int* launches) {
  *launches = 0;
  int lg_n = 0;
  while ((1LL << lg_n) < n) ++lg_n;
  const int depth = lg_n - cap_height;
  const uint64_t* in = static_cast<const uint64_t*>(leaves);
  uint64_t* dst = static_cast<uint64_t*>(out);
  for (int level = 0; level < depth;) {
    const int lg_layer = lg_n - level;
    int lg_in, levels;
    if (lg_layer <= TREE_LG_TOP) {        // one block to the cap
      lg_in = lg_layer;
      levels = depth - level;
    } else {                              // 2^7 subtrees at most
      levels = lg_layer - TREE_LG_TOP;
      if (levels > TREE_LG_ONE_BLOCK) levels = TREE_LG_ONE_BLOCK;
      if (levels > depth - level) levels = depth - level;
      lg_in = levels;
    }
    const size_t smem = (size_t)(3 * DIGEST * sizeof(uint64_t)) << (lg_in - 1);
    merkle_kernel<<<(unsigned)(1LL << (lg_layer - lg_in)), TREE_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        in, dst, n, level, lg_in, levels);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    ++*launches;
    level += levels;
    in = dst + DIGEST * (n - (n >> (level - 1)));
  }
  return 0;
}
