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
// - One permutation, the struct `Poseidon`, for every entry: the reference
//   permutation in its fast-partial-round form, one thread per state, the
//   state in registers. Measured against the plain schedule (an MDS layer
//   in every partial round): 0.97 against 1.16 ms at 2^19 states (PERF.md).
// - The Goldilocks arithmetic of goldilocks_lazy.cuh: PTX carry chains on
//   32-bit limbs, values anywhere in [0, 2^64) between operations, made
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
// - The kernels, their grid and the tree are those of sponge_kernels.cuh,
//   shared with Poseidon2 (poseidon2.cu).

#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks_lazy.cuh"
#include "poseidon_tables.h"
#include "sponge_kernels.cuh"

namespace {

constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;

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

// The permutation of the sponge kernels (sponge_kernels.cuh). `permute`
// takes 242 registers, so two blocks of 128 threads fit on an SM; code that
// took fewer registers and ran 16 warps on an SM was slower (PERF.md).
struct Poseidon {
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr long long LANE_LEAVES = 0;
  struct Lane {
    uint32_t row[W];   // the lane's MDS row
  };
  static __device__ __forceinline__ Lane lane(int l) {
    Lane c;
#pragma unroll
    for (int i = 0; i < W; ++i) c.row[i] = C_MDS[(l < W ? l : 0) * W + i];
    return c;
  }

  // The reference permutation in its fast-partial-round form (poseidon.rs
  // `poseidon`; the tables of poseidon_fast.py): full rounds 0-3, the
  // partial rounds, full rounds 26-29, each in a rolled loop. C_FULL_RC[r]
  // holds the constants added after the r-th full round (the next round's,
  // C_FIRST_RC after round 3, zeros after the last). One loop over all
  // eight full rounds with the partial rounds inside it made smaller code
  // (5.5k against 7.0k SASS instructions) but ran 5% slower at 2^19 states
  // and 15% slower per permutation alone (PERF.md).
  static __device__ __forceinline__ void permute(uint64_t s[W]) {
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = add_canon(s[i], C_RC[i]);
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
    partial_rounds(s);
#pragma unroll 1
    for (int r = HALF_FULL; r < 2 * HALF_FULL; ++r) full_round(s, r);
  }

  // The same permutation spread over the 16 lanes of a group, lane l < 12
  // holding s[l] and `lc.row` its MDS row (lanes 12-15 compute what is
  // ignored), in the plain schedule: the full MDS in every round, one S-box
  // on lane 0 in a partial round. A round costs one S-box, 24 shuffles and
  // one MDS row per lane: a permutation's latency is about a third of
  // `permute`'s (a tree level of 16 permutations 16 against 42 us on the
  // H100), for about three times its lane-instructions, so it serves the
  // tree levels that have too few permutations to fill the card.
  static __device__ __forceinline__ uint64_t permute_lanes(uint64_t x, int l,
                                                           const Lane& lc) {
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
        L = mad_wide(__shfl_sync(0xFFFFFFFFu, lo, c, 16), lc.row[c], L);
        H = mad_wide(__shfl_sync(0xFFFFFFFFu, hi, c, 16), lc.row[c], H);
      }
      x = reduce_lh(L, H);
    }
    return x;
  }
};

}  // namespace

extern "C" int poseidon_permute(const void* states_in, void* states_out,
                                long long n, void* stream) {
  return launch_permute<Poseidon>(states_in, states_out, n, stream);
}

extern "C" int poseidon_hash_leaves(const void* x, void* out, int L,
                                    long long n, void* stream) {
  return launch_hash_leaves<Poseidon>(x, out, L, n, stream);
}

extern "C" int poseidon_merkle_tree(const void* leaves, void* out,
                                    long long n, int cap_height,
                                    void* stream, int* launches) {
  return launch_merkle_tree<Poseidon>(leaves, out, n, cap_height, stream,
                                      launches);
}
