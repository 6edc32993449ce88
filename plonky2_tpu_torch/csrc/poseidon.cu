// K2 and K3: the Poseidon width-12 permutation over Goldilocks and the fused
// leaf sponge.
//
// K2 `poseidon_permute` replaces plonky2_tpu/ops/pallas_poseidon.py
// `_permute_fn_soa_v3` (:335); K3 `poseidon_hash_leaves` replaces
// `_leaf_hash_fn_pallas` (:410). Both compute the reference permutation in
// its fast-partial-round form (plonky2_tpu/hash/poseidon_fast.py): 4 full
// rounds, the partial-round init (constant layer + 11x11 matrix), 22 sparse
// partial rounds with the w_hat / v tables, 4 full rounds; x^7 S-box and the
// circulant MDS plus its diagonal.
//
// Bound: 64-bit integer multiplies (about 570 per permutation: 8 x 12
// S-boxes, the 121-entry init matrix, 22 x (4 + 22) in the partial rounds),
// against 96 bytes of state in and out. The design keeps the whole state in
// registers for every round (one thread per state), reads the round tables
// from __constant__ memory, where every thread of a warp reads the same
// entry, and does the small-constant MDS in 32-bit halves summed before one
// reduction. K3 reads each leaf once, straight from the [L, N] LDE (thread i
// reads column i, so a warp reads consecutive addresses), absorbs all
// ceil(L/8) chunks with the state in registers and writes only the [N, 4]
// digest.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"
#include "poseidon_tables.h"

namespace {

constexpr int W = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl_mul(x, x);
  const uint64_t x3 = gl_mul(x2, x);
  const uint64_t x6 = gl_mul(x3, x3);
  return gl_mul(x6, x);
}

// out[r] = sum_i CIRC[i] * s[(i + r) % 12] + DIAG[r] * s[r]; the constants
// are < 2^6, so each half-sum stays below 2^42 before one reduction.
__device__ __forceinline__ void mds(uint64_t s[W]) {
  uint64_t out[W];
#pragma unroll
  for (int r = 0; r < W; ++r) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t v = s[(i + r) % W];
      lo += (v & 0xFFFFFFFFULL) * C_MDS_CIRC[i];
      hi += (v >> 32) * C_MDS_CIRC[i];
    }
    lo += (s[r] & 0xFFFFFFFFULL) * C_MDS_DIAG[r];
    hi += (s[r] >> 32) * C_MDS_DIAG[r];
    const uint64_t z_lo = lo + (hi << 32);
    const uint64_t z_hi = (hi >> 32) + (z_lo < lo ? 1 : 0);
    out[r] = gl_reduce128(z_lo, z_hi);
  }
#pragma unroll
  for (int r = 0; r < W; ++r) s[r] = out[r];
}

__device__ __forceinline__ void full_round(uint64_t s[W], int round) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = sbox(gl_add(s[i], C_RC[round * W + i]));
  mds(s);
}

__device__ void permute(uint64_t s[W]) {
#pragma unroll
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);

#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = gl_add(s[i], C_FIRST_RC[i]);
  uint64_t t[W - 1];
#pragma unroll
  for (int c = 0; c < W - 1; ++c) {
    uint64_t acc = 0;
#pragma unroll
    for (int r = 0; r < W - 1; ++r)
      acc = gl_add(acc, gl_mul(s[r + 1], C_INIT_MAT[r * (W - 1) + c]));
    t[c] = acc;
  }
#pragma unroll
  for (int c = 0; c < W - 1; ++c) s[c + 1] = t[c];

  const uint64_t m00 = C_MDS_CIRC[0] + C_MDS_DIAG[0];
#pragma unroll 2
  for (int r = 0; r < PARTIAL; ++r) {
    // the last partial round adds no constant (its table entry is 0)
    const uint64_t s0 = gl_add(sbox(s[0]), C_PARTIAL_RC[r]);
    uint64_t d = gl_mul(s0, m00);
#pragma unroll
    for (int i = 1; i < W; ++i) {
      d = gl_add(d, gl_mul(s[i], C_W_HATS[r * (W - 1) + i - 1]));
      s[i] = gl_add(s[i], gl_mul(s0, C_VS[r * (W - 1) + i - 1]));
    }
    s[0] = d;
  }

#pragma unroll
  for (int r = HALF_FULL + PARTIAL; r < 2 * HALF_FULL + PARTIAL; ++r)
    full_round(s, r);
}

__global__ void permute_kernel(const uint64_t* in, uint64_t* out,
                               long long n) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = in[b * W + i];
  permute(s);
#pragma unroll
  for (int i = 0; i < W; ++i) out[b * W + i] = s[i];
}

__global__ void hash_leaves_kernel(const uint64_t* x, uint64_t* out, int L,
                                   long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint64_t s[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = 0;
  for (int start = 0; start < L; start += RATE) {
    const int len = L - start < RATE ? L - start : RATE;
#pragma unroll
    for (int k = 0; k < RATE; ++k)
      if (k < len) s[k] = x[(long long)(start + k) * n + col];
    permute(s);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[col * 4 + k] = s[k];
}

}  // namespace

// states_in, states_out: [n, 12] contiguous.
extern "C" int poseidon_permute(const void* states_in, void* states_out,
                                long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  permute_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(states_in),
      static_cast<uint64_t*>(states_out), n);
  return (int)cudaGetLastError();
}

// x: [L, n] contiguous (column i is leaf i); out: [n, 4] digests of the
// overwrite-mode sponge hash_no_pad over each column.
extern "C" int poseidon_hash_leaves(const void* x, void* out, int L,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  hash_leaves_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out), L, n);
  return (int)cudaGetLastError();
}
