// K6 and K7: the Poseidon2 width-12 permutation over Goldilocks, the fused
// leaf sponge and the Merkle tree above the leaves (the hasher of
// Poseidon2GoldilocksConfig).
//
// K6 `poseidon2_permute` and `poseidon2_merkle_tree` replace
// plonky2_tpu/ops/pallas_poseidon2.py `_permute2_fn_soa` (:124): the first
// permutes any batch of states (the FRI PoW wave), the second builds every
// layer of a Merkle tree above its leaf digests in at most two launches. K7
// `poseidon2_hash_leaves` replaces `_leaf2_hash_fn_pallas` (:161), the
// overwrite-mode sponge hash_no_pad over each leaf column.
//
// Schedule (reference poseidon2.rs:448-476): the external layer, 4 full
// rounds, 22 internal rounds, 4 full rounds. A full round adds its 12
// constants, applies x^7 to every element and the external layer: three M4
// blocks (apply_m_4:329-345) plus the column sums of the blocks added back
// to each block, which is the matrix E with 2 M4 on its diagonal blocks and
// M4 off them (entries at most 14, row sums 64 and 48). An internal round
// adds one constant to s[0], applies x^7 to s[0] only, then
// s[i] = s[i] DIAG[i] + sum(s) with full 64-bit DIAG constants.
//
// Bound: operations. 736 general 64-bit field multiplies per permutation
// (the S-boxes of 8 full rounds x 12 and 22 internal rounds x 1, 4 each,
// and the 22 x 12 products by DIAG) against 96 bytes of state in and out,
// L x 8 bytes of leaf in and 32 out, or 32 bytes of digest in and out for
// each tree node.
//
// Design:
// - One permutation, the struct `Poseidon2`, for every entry, on the
//   Goldilocks arithmetic of goldilocks_lazy.cuh: values anywhere in
//   [0, 2^64) between operations, canonical once on the way out, so any
//   64-bit input is taken.
// - The external layer on 32-bit halves: the M4 adds and the column sums
//   run on the low halves and the high halves separately, in plain 64-bit
//   integers (each sum below 2^38 + 2^32, the next round's constants
//   starting the sums), with one reduction per output.
// - The internal layer: sum(s) on the halves in two accumulators and one
//   reduction, then one multiply-add and one reduction per element.
// - The round loops are rolled, the constants read from __constant__
//   memory at a uniform address; the kernels, their grid and the tree are
//   those of sponge_kernels.cuh, shared with Poseidon (poseidon.cu).
// - `permute_lanes`, the permutation over 16 lanes, serves the tree's
//   upper levels and the leaf batches too narrow to fill the card.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks_lazy.cuh"
#include "poseidon2_tables.h"
#include "sponge_kernels.cuh"

namespace {

constexpr int HALF_F = 4;
constexpr int ROUNDS_P = 22;
constexpr uint64_t M32 = 0xFFFFFFFFULL;

// apply_m_4 on v[0..4), values below 2^32: [t6, t5, t7, t4], each below
// 2^36 (the rows of M4 sum to 16 and 12)
__device__ __forceinline__ void m4(uint64_t* v) {
  const uint64_t t0 = v[0] + v[1], t1 = v[2] + v[3];
  const uint64_t t2 = 2 * v[1] + t1, t3 = 2 * v[3] + t0;
  const uint64_t t4 = 4 * t1 + t3, t5 = 4 * t0 + t2;
  v[0] = t3 + t5;
  v[1] = t5;
  v[2] = t2 + t4;
  v[3] = t4;
}

// s <- E s + rc for any s < 2^64 and rc canonical: E on the low and the high
// halves of s, each output below 64 (2^32 - 1) + 2^32, then one reduce_lh
// per element.
__device__ __forceinline__ void external_layer(uint64_t s[W],
                                               const uint64_t* rc) {
  uint64_t lo[W], hi[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    lo[i] = s[i] & M32;
    hi[i] = s[i] >> 32;
  }
#pragma unroll
  for (int b = 0; b < W; b += 4) {
    m4(lo + b);
    m4(hi + b);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t sl = lo[k] + lo[4 + k] + lo[8 + k];
    const uint64_t sh = hi[k] + hi[4 + k] + hi[8 + k];
#pragma unroll
    for (int b = 0; b < W; b += 4) {
      const uint64_t c = rc[b + k];
      s[b + k] = reduce_lh(lo[b + k] + sl + (c & M32),
                           hi[b + k] + sh + (c >> 32));
    }
  }
}

__device__ __forceinline__ void full_round(uint64_t s[W], int f) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = sbox(s[i]);
  external_layer(s, C2_EXT_RC + W * (f + 1));
}

// The 22 internal rounds, then the constants of the first full round after
// them.
__device__ __forceinline__ void internal_rounds(uint64_t s[W]) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS_P; ++r) {
    s[0] = sbox(add_canon(s[0], C2_PARTIAL_RC[r]));
    uint64_t L = 0, H = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      L += s[i] & M32;
      H += s[i] >> 32;
    }
    const uint64_t total = reduce_lh(L, H);
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = mul_add(s[i], C2_DIAG[i], total);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = add_canon(s[i], C2_MID_RC[i]);
}

// The permutation of the sponge kernels (sponge_kernels.cuh).
// C2_EXT_RC[k] holds the constants added after the k-th external layer (the
// next full round's; zeros before the internal rounds and after the last);
// C2_MID_RC the first full round's after the internal rounds.
struct Poseidon2 {
  // At 95 (permutation) and 109 (leaf sponge) registers four blocks of 128
  // threads fit on an SM, and a grid of four a SM ran fastest (two: 6%
  // slower at 2^19 states; five and six, with the registers capped to fit:
  // 8-9% slower).
  static constexpr int BLOCKS_PER_SM = 4;
  // The 16-lane sponge ran the FRI leaves [32, 2^9|2^5] in 0.047 against
  // 0.102 ms one thread per column, and lost at [32, 2^13] (0.152 against
  // 0.103 ms), where 2^17 lanes are no longer latency-bound.
  static constexpr long long LANE_LEAVES = 1 << 9;
  struct Lane {
    uint32_t row[W];   // the lane's row of E
    uint64_t diag;     // its DIAG entry
    int li;            // its element (lanes 12-15 take element 0)
  };
  static __device__ __forceinline__ Lane lane(int l) {
    Lane c;
    c.li = l < W ? l : 0;
#pragma unroll
    for (int i = 0; i < W; ++i) c.row[i] = C2_EXT[c.li * W + i];
    c.diag = C2_DIAG[c.li];
    return c;
  }

  // One rolled loop over the 8 full rounds, the internal rounds inside it
  // before the fifth: 2,656 SASS instructions in `permute_kernel` and 95
  // registers, against 4,200 and 96 with a loop for each half, which ran
  // 4-10% slower at 2^19 states and, at four blocks a SM, 22% slower in
  // the leaf sponge (PERF.md).
  static __device__ __forceinline__ void permute(uint64_t s[W]) {
    external_layer(s, C2_EXT_RC);
#pragma unroll 1
    for (int f = 0; f < 2 * HALF_F; ++f) {
      if (f == HALF_F) internal_rounds(s);
      full_round(s, f);
    }
  }

  // Lane l's row of E times the state, through 24 shuffles of the 32-bit
  // halves, plus the constant rc[l].
  static __device__ __forceinline__ uint64_t external_lanes(
      uint64_t x, const Lane& lc, const uint64_t* rc) {
    const uint64_t k = rc[lc.li];
    uint64_t L = k & M32, H = k >> 32;
    const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
#pragma unroll
    for (int c = 0; c < W; ++c) {
      L = mad_wide(__shfl_sync(0xFFFFFFFFu, lo, c, LANES), lc.row[c], L);
      H = mad_wide(__shfl_sync(0xFFFFFFFFu, hi, c, LANES), lc.row[c], H);
    }
    return reduce_lh(L, H);
  }

  // The same permutation over the 16 lanes of a group, lane l < 12 holding
  // s[l] (lanes 12-15 compute what is ignored). A full round is one S-box
  // and one row of E per lane; an internal round the S-box on lane 0, sum(s)
  // as a butterfly of the halves' sums over the group, and one multiply-add
  // per lane.
  static __device__ __forceinline__ uint64_t permute_lanes(uint64_t x, int l,
                                                           const Lane& lc) {
    x = external_lanes(x, lc, C2_EXT_RC);
#pragma unroll 1
    for (int f = 0; f < 2 * HALF_F; ++f) {
      if (f == HALF_F) {
#pragma unroll 1
        for (int r = 0; r < ROUNDS_P; ++r) {
          if (l == 0) x = sbox(add_canon(x, C2_PARTIAL_RC[r]));
          uint64_t L = l < W ? x & M32 : 0, H = l < W ? x >> 32 : 0;
#pragma unroll
          for (int m = LANES / 2; m > 0; m /= 2) {
            L += __shfl_xor_sync(0xFFFFFFFFu, L, m, LANES);
            H += __shfl_xor_sync(0xFFFFFFFFu, H, m, LANES);
          }
          x = mul_add(x, lc.diag, reduce_lh(L, H));
        }
        x = add_canon(x, C2_MID_RC[lc.li]);
      }
      x = external_lanes(sbox(x), lc, C2_EXT_RC + W * (f + 1));
    }
    return x;
  }
};

}  // namespace

extern "C" int poseidon2_permute(const void* states_in, void* states_out,
                                 long long n, void* stream) {
  return launch_permute<Poseidon2>(states_in, states_out, n, stream);
}

extern "C" int poseidon2_hash_leaves(const void* x, void* out, int L,
                                     long long n, void* stream) {
  return launch_hash_leaves<Poseidon2>(x, out, L, n, stream);
}

extern "C" int poseidon2_merkle_tree(const void* leaves, void* out,
                                     long long n, int cap_height,
                                     void* stream, int* launches) {
  return launch_merkle_tree<Poseidon2>(leaves, out, n, cap_height, stream,
                                       launches);
}
