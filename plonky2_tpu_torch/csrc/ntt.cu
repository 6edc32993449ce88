// K1: batched radix-2 DIT butterflies for the Goldilocks NTT.
//
// Replaces plonky2_tpu/ops/ntt_mxu_pallas.py `_level_fn` (:94, body `_kernel`
// :40): one level of a four-step DFT done as int8-limb banded matmuls on the
// TPU's MXU. Here the transform itself is ported, not that formulation: the
// caller bit-reverses the input (and, for an LDE, repeats each entry
// 2^rate_bits times), this kernel runs stages [start_stage, lg_n) of the
// radix-2 DIT network in place, and the output is in natural order, equal to
// plonky2_tpu/ops/ntt.py at every size 2^1..2^17.
//
// Bound: device memory. A butterfly is one 64x64->128 multiply and a few
// adds per 16 bytes read and written, far below the card's integer rate, so
// the design minimises passes over the array: a shared-memory kernel runs all
// stages that stay inside a tile of 2^11 elements (16 KB) in one read and one
// write, and only the remaining lg_n - 11 stages (6 at 2^17) make one global
// pass each. Twiddles come from one table w^0..w^{n/2-1} uploaded once per
// size; stage s reads it with stride 2^(lg_n-1-s).
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kTileLg = 11;

__global__ void dit_shared(uint64_t* x, const uint64_t* tw, int lg_n,
                           int lg_tile, int start, int end) {
  extern __shared__ uint64_t s[];
  const int tile = 1 << lg_tile;
  uint64_t* base = x + (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = base[i];
  __syncthreads();
  for (int st = start; st < end; ++st) {
    const int m = 1 << st;
    const int shift = lg_n - 1 - st;
    for (int k = threadIdx.x; k < tile / 2; k += blockDim.x) {
      const int j = k & (m - 1);
      const int i0 = ((k >> st) << (st + 1)) | j;
      const uint64_t w = tw[(size_t)j << shift];
      const uint64_t u = s[i0];
      const uint64_t t = gl_mul(w, s[i0 + m]);
      s[i0] = gl_add(u, t);
      s[i0 + m] = gl_sub(u, t);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) base[i] = s[i];
}

__global__ void dit_stage(uint64_t* x, const uint64_t* tw, int lg_n, int st,
                          long long total) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= total) return;
  const long long half_mask = (1LL << (lg_n - 1)) - 1;
  const long long row = b >> (lg_n - 1);
  const long long k = b & half_mask;
  const long long m = 1LL << st;
  const long long j = k & (m - 1);
  const long long i0 = ((k >> st) << (st + 1)) | j;
  uint64_t* r = x + (row << lg_n);
  const uint64_t w = tw[j << (lg_n - 1 - st)];
  const uint64_t u = r[i0];
  const uint64_t t = gl_mul(w, r[i0 + m]);
  r[i0] = gl_add(u, t);
  r[i0 + m] = gl_sub(u, t);
}

}  // namespace

// x: [batch, 2^lg_n] contiguous, bit-reversed order in, natural order out.
// tw: [2^(lg_n-1)] powers of the primitive 2^lg_n-th root of unity.
extern "C" int ntt_dit(void* x, const void* tw, long long batch, int lg_n,
                       int start_stage, void* stream) {
  if (lg_n < 1 || start_stage >= lg_n || batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* xp = static_cast<uint64_t*>(x);
  const uint64_t* twp = static_cast<const uint64_t*>(tw);
  const int lg_tile = lg_n < kTileLg ? lg_n : kTileLg;
  if (start_stage < lg_tile) {
    const long long tiles = batch << (lg_n - lg_tile);
    const int threads = 1 << (lg_tile - 1);
    dit_shared<<<(unsigned)tiles, threads, sizeof(uint64_t) << lg_tile, s>>>(
        xp, twp, lg_n, lg_tile, start_stage, lg_tile);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = batch << (lg_n - 1);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  for (int st = start_stage > lg_tile ? start_stage : lg_tile; st < lg_n;
       ++st) {
    dit_stage<<<blocks, threads, 0, s>>>(xp, twp, lg_n, st, total);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
