// K6 and K7: the Poseidon2 width-12 permutation over Goldilocks and the
// fused leaf sponge (the hasher of Poseidon2GoldilocksConfig).
//
// K6 `poseidon2_permute` replaces plonky2_tpu/ops/pallas_poseidon2.py
// `_permute2_fn_soa` (:124); K7 `poseidon2_hash_leaves` replaces
// `_leaf2_hash_fn_pallas` (:161). Schedule (reference poseidon2.rs:448-476):
// the external layer, 4 full rounds, 22 internal rounds, 4 full rounds. A
// full round adds its 12 constants, applies x^7 to every element and the
// external layer: three M4 blocks (adds and doublings, apply_m_4:329-345)
// plus the column sums of the blocks added back to each block. An internal
// round adds one constant to s[0], applies x^7 to s[0] only, then
// s[i] = s[i] * DIAG[i] + sum(s) with full 64-bit DIAG constants.
//
// Bound: 64-bit integer multiplies, not bytes: 736 field multiplies per
// permutation (8 x 12 S-boxes x 4 in the full rounds, 22 x (4 + 12) in the
// internal ones) against 96 bytes of state in and out. One thread per state;
// the 12 words stay in registers for all 30 rounds, every loop is unrolled,
// the constants sit in __constant__ memory (every thread of a warp reads the
// same entry), and every add of the external layer is reduced mod p because
// sums such as 4 * t1 + t3 overflow 64 bits unreduced. K7 reads leaf i as
// column i of the [L, N] LDE (a warp reads consecutive addresses), absorbs
// all ceil(L/8) chunks with the state in registers and writes only the
// [N, 4] digest.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"
#include "poseidon2_tables.h"

namespace {

constexpr int W = 12;
constexpr int RATE = 8;
constexpr int HALF_F = 4;
constexpr int ROUNDS_P = 22;

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl_mul(x, x);
  const uint64_t x3 = gl_mul(x2, x);
  const uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(x3, x4);
}

// apply_m_4 on s[b..b+4): [t6, t5, t7, t4].
__device__ __forceinline__ void m4(uint64_t s[W], int b) {
  const uint64_t t0 = gl_add(s[b], s[b + 1]);
  const uint64_t t1 = gl_add(s[b + 2], s[b + 3]);
  const uint64_t t2 = gl_add(gl_add(s[b + 1], s[b + 1]), t1);
  const uint64_t t3 = gl_add(gl_add(s[b + 3], s[b + 3]), t0);
  const uint64_t t1x2 = gl_add(t1, t1);
  const uint64_t t4 = gl_add(gl_add(t1x2, t1x2), t3);
  const uint64_t t0x2 = gl_add(t0, t0);
  const uint64_t t5 = gl_add(gl_add(t0x2, t0x2), t2);
  s[b] = gl_add(t3, t5);
  s[b + 1] = t5;
  s[b + 2] = gl_add(t2, t4);
  s[b + 3] = t4;
}

__device__ __forceinline__ void external_layer(uint64_t s[W]) {
  m4(s, 0);
  m4(s, 4);
  m4(s, 8);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t sum = gl_add(gl_add(s[k], s[4 + k]), s[8 + k]);
    s[k] = gl_add(s[k], sum);
    s[4 + k] = gl_add(s[4 + k], sum);
    s[8 + k] = gl_add(s[8 + k], sum);
  }
}

// Full round f of 8: f < 4 are the rounds before the internal ones.
__device__ __forceinline__ void full_round(uint64_t s[W], int f) {
#pragma unroll
  for (int i = 0; i < W; ++i)
    s[i] = sbox7(gl_add(s[i], C2_FULL_RC[f * W + i]));
  external_layer(s);
}

__device__ __forceinline__ void permute2(uint64_t s[W]) {
  external_layer(s);
#pragma unroll
  for (int f = 0; f < HALF_F; ++f) full_round(s, f);
#pragma unroll
  for (int r = 0; r < ROUNDS_P; ++r) {
    s[0] = sbox7(gl_add(s[0], C2_PARTIAL_RC[r]));
    uint64_t total = s[0];
#pragma unroll
    for (int i = 1; i < W; ++i) total = gl_add(total, s[i]);
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = gl_add(gl_mul(s[i], C2_DIAG[i]), total);
  }
#pragma unroll
  for (int f = HALF_F; f < 2 * HALF_F; ++f) full_round(s, f);
}

__global__ void permute2_kernel(const uint64_t* in, uint64_t* out,
                                long long n) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint64_t s[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = in[b * W + i];
  permute2(s);
#pragma unroll
  for (int i = 0; i < W; ++i) out[b * W + i] = s[i];
}

__global__ void hash2_leaves_kernel(const uint64_t* x, uint64_t* out, int L,
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
    permute2(s);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[col * 4 + k] = s[k];
}

}  // namespace

// states_in, states_out: [n, 12] contiguous.
extern "C" int poseidon2_permute(const void* states_in, void* states_out,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  permute2_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(states_in),
      static_cast<uint64_t*>(states_out), n);
  return (int)cudaGetLastError();
}

// x: [L, n] contiguous (column i is leaf i); out: [n, 4] digests of the
// overwrite-mode sponge hash_no_pad over each column.
extern "C" int poseidon2_hash_leaves(const void* x, void* out, int L,
                                     long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  hash2_leaves_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out), L, n);
  return (int)cudaGetLastError();
}
