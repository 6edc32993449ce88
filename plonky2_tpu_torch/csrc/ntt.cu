// K1: the batched Goldilocks NTT as the whole transform the prover calls.
//
// Replaces plonky2_tpu/ops/ntt_mxu_pallas.py `_level_fn` (:94, body `_kernel`
// :40): one level of a four-step DFT done as int8-limb banded matmuls on the
// TPU's MXU. Here the transform itself is ported, not that formulation. Two
// entries, each reading its input once and writing its output once:
// - `ntt_forward`: coefficients [B, n] in natural order to values
//   [B, n 2^rate] with out[b, j] = sum_i c[b, i] shift^i w_N^(ij), N = n
//   2^rate: the coset LDE, or fft / coset_fft at rate 0;
// - `ntt_inverse`: values [B, n] to coefficients, out[b, i] = scale[i]
//   sum_j v[b, j] w_n^(-ij), where scale[i] = shift^(-i) / n.
// Both are one radix-2 DIT network over the bit-reversed input x, with x[k]
// = c'[rev(k >> rate)] (each coefficient repeated 2^rate times, which is
// the zero-padded input after its first `rate` stages, so those are
// skipped), output in natural order and canonical. The forward's shift
// powers are multiplied in as x is gathered; the inverse runs on the
// inverse root's twiddles, so it needs no index reversal, and its store
// multiplies by the scale table.
//
// Bound: by bytes, device memory (B n reads and B N writes of 8 bytes
// against one 64 x 64-bit product a butterfly); in practice the integer
// issue rate, at about 50 SASS instructions a butterfly (PERF.md). The
// design keeps the array's trips through device memory to one or two and
// the instructions a butterfly few:
// - A row of N <= 2^kRowLg elements is one block: gathered into shared
//   memory, every stage there, stored once. One launch.
// - A longer row takes two launches, each one pass: pass A (`ntt_tiles`)
//   runs the stages inside contiguous tiles of 2^lg_T in shared memory;
//   pass B (`ntt_columns`) runs the rest, one thread a column of N / 2^lg_T
//   elements at stride 2^lg_T, in registers, so that a warp's loads and
//   stores are contiguous. The tile is 2^kTileLg, shrunk for small batches
//   until pass A has kMinBlocks blocks: a block of 16 warps runs about one
//   butterfly a clock, so a call of few rows must spread over the SMs.
// - A row above 2^(kTileLg + kMaxColLg) (2^19) has more stages above the
//   tile than a column holds in registers: pass B then runs as two column
//   rounds (three launches), the first over the lower c1 = c / 2 of those
//   c stages at stride 2^lg_T, storing unreduced values, the second over
//   the rest at stride 2^(lg_T + c1). The first round is the smaller one:
//   at 2^24, 6 stages unreduced take 255 registers and spill, 5 do not.
//   Rows up to 2^kMaxLg (2^24) are taken.
// - Stages run three at a time in registers (radix 8), so shared memory is
//   read and written once per three stages.
// - Twiddles come from one table a direction and size, stage-major
//   (tw[2^s + j] = w_(2^(s+1))^j), so the threads of a warp read
//   neighbouring entries; it is 8 N bytes and stays in L2.
// - The arithmetic of goldilocks_lazy.cuh: carry chains with values left
//   anywhere in [0, 2^64), made canonical once, at the final store.
// - The bit-reversed gather reads each input element once, but a warp's 32
//   reads land in 32 sectors; tiles whose reads share sectors run next to
//   each other, so the sectors come from L2.
// Measured and dropped (PERF.md): clusters of blocks whose top stages read
// each other's shared memory, one block a 2^14 row, four stages a round,
// the butterfly in one asm block, a padded shared-memory layout.
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

#include "goldilocks_lazy.cuh"

namespace {

constexpr int kRowLg = 10;          // rows up to 2^kRowLg: one block each
constexpr int kTileLg = 13;         // pass A's largest tile for longer rows
// pass A's tile shrinks until it has kMinBlocks blocks, down to
// 2^kMinTileLg and to pass B columns of 2^kShrinkColLg
constexpr int kMinTileLg = 9;
constexpr int kMinBlocks = 512;
constexpr int kShrinkColLg = 4;
constexpr int kMaxColLg = 6;        // pass B's columns: up to 2^6 elements
constexpr int kMaxLg = 24;          // the longest row: 2^24 elements
constexpr int kRadixLg = 3;         // stages a round in registers
constexpr int kThreads = 512;
constexpr int kColThreads = 128;

struct Args {
  const uint64_t* in;    // row b at in + b * in_stride, n elements
  uint64_t* out;         // [B, N]
  const uint64_t* tw;    // [N], tw[2^s + j] = w_(2^(s+1))^(+-j)
  const uint64_t* pre;   // [n] multiplied in at the gather, or null
  const uint64_t* post;  // [N] multiplied in at the final store, or null
  long long in_stride;
  long long batch;
  int lg_N;
  int rate;
  int lg_T;              // pass A's tile (two passes only)
};

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits == 0 ? 0 : __brev(x) >> (32 - bits);
}

// (y, x) <- (y + w x, y - w x) mod p for any y, x, w < 2^64
__device__ __forceinline__ void butterfly(uint64_t& y, uint64_t& x,
                                          uint64_t w) {
  const uint64_t t = mul(w, x);
  x = sub_lazy(y, t);
  y = add_lazy(y, t);
}

// s[k] = x[k0 + k] for k < 2^lg_T (lg_T >= rate): the shifted input,
// bit-reversed and each element repeated 2^rate times
__device__ __forceinline__ void gather(const Args& a, long long row,
                                       uint32_t k0, int lg_T, uint64_t* s) {
  const int lg_n = a.lg_N - a.rate;
  const uint64_t* in = a.in + row * a.in_stride;
  const uint32_t count = 1u << (lg_T - a.rate);
  for (uint32_t e = threadIdx.x; e < count; e += blockDim.x) {
    const uint32_t i = rev_bits((k0 >> a.rate) + e, lg_n);
    uint64_t v = __ldg(in + i);
    if (a.pre) v = mul(v, __ldg(a.pre + i));
    uint64_t* d = s + (e << a.rate);
    if (a.rate == 0) {
      d[0] = v;
    } else {
      for (int r = 0; r < (1 << a.rate); r += 2)
        *reinterpret_cast<ulonglong2*>(d + r) = make_ulonglong2(v, v);
    }
  }
}

// Stages s0 .. s0 + K - 1 on v[q] = x[base + q 2^s0], b = base mod 2^s0.
// Stage s pairs k and k + 2^s (bit s of k clear) with twiddle
// w_(2^(s+1))^(k mod 2^s).
template <int K>
__device__ __forceinline__ void butterflies(uint64_t* v, const uint64_t* tw,
                                            int s0, uint32_t b) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int m = 1 << u;
    const uint64_t* t = tw + (1u << (s0 + u)) + b;
#pragma unroll
    for (int q = 0; q < (1 << K); ++q) {
      if (q & m) continue;
      butterfly(v[q], v[q + m], __ldg(t + ((q & (m - 1)) << s0)));
    }
  }
}

// K stages from s0 on a tile of 2^lg_T elements in shared memory
template <int K>
__device__ __forceinline__ void round_shared(uint64_t* s, const uint64_t* tw,
                                             int lg_T, int s0) {
  const uint32_t low = (1u << s0) - 1;
  for (uint32_t g = threadIdx.x; g < (1u << (lg_T - K)); g += blockDim.x) {
    const uint32_t b = g & low;
    const uint32_t base = b | ((g >> s0) << (s0 + K));
    uint64_t v[1 << K];
#pragma unroll
    for (int q = 0; q < (1 << K); ++q) v[q] = s[base + (q << s0)];
    butterflies<K>(v, tw, s0, b);
#pragma unroll
    for (int q = 0; q < (1 << K); ++q) s[base + (q << s0)] = v[q];
  }
}

// stages [start, lg_T) of a tile in shared memory in the fewest rounds of
// at most kRadixLg stages, as even as they can be
__device__ __forceinline__ void stages_shared(uint64_t* s, const uint64_t* tw,
                                              int lg_T, int start) {
  for (int st = start; st < lg_T;) {
    const int left = lg_T - st;
    const int rounds = (left + kRadixLg - 1) / kRadixLg;
    const int k = (left + rounds - 1) / rounds;
    if (k == 3) {
      round_shared<3>(s, tw, lg_T, st);
    } else if (k == 2) {
      round_shared<2>(s, tw, lg_T, st);
    } else {
      round_shared<1>(s, tw, lg_T, st);
    }
    st += k;
    __syncthreads();
  }
}

// the final store of out[k]: times post[k], canonical
__device__ __forceinline__ uint64_t finish(const Args& a, uint64_t v,
                                          uint32_t k) {
  if (a.post) v = mul(v, __ldg(a.post + k));
  return canonical(v);
}

// one block a row of N <= 2^kRowLg
__global__ void __launch_bounds__(kThreads) ntt_row(Args a) {
  extern __shared__ uint64_t s[];
  const long long row = blockIdx.x;
  gather(a, row, 0, a.lg_N, s);
  __syncthreads();
  stages_shared(s, a.tw, a.lg_N, a.rate);
  uint64_t* out = a.out + (row << a.lg_N);
  for (uint32_t k = threadIdx.x; k < (1u << a.lg_N); k += blockDim.x)
    out[k] = finish(a, s[k], k);
}

// pass A: stages [rate, lg_T) of tile t of a row, left unreduced in out
__global__ void __launch_bounds__(kThreads, 2) ntt_tiles(Args a) {
  extern __shared__ uint64_t s[];
  const int lg_T = a.lg_T;
  const int lg_tiles = a.lg_N - lg_T;
  const long long row = blockIdx.x >> lg_tiles;
  // tile rev(i) after tile rev(i - 1): their gathers read the same sectors
  const uint32_t t = rev_bits(blockIdx.x & ((1u << lg_tiles) - 1), lg_tiles);
  gather(a, row, t << lg_T, lg_T, s);
  __syncthreads();
  stages_shared(s, a.tw, lg_T, a.rate);
  uint64_t* out = a.out + (row << a.lg_N) + ((size_t)t << lg_T);
  for (uint32_t k = threadIdx.x; k < (1u << lg_T); k += blockDim.x)
    out[k] = s[k];
}

// pass B: stages [s0, s0 + C_LG) on the columns x[base + q 2^s0], base =
// the thread's index with bits s0 .. s0 + C_LG - 1 spread clear; the last
// round (s0 + C_LG = lg_N) stores canonical values, an earlier one leaves
// them unreduced
template <int C_LG, bool kLast>
__global__ void __launch_bounds__(kColThreads) ntt_columns(Args a, int s0) {
  const int lg_cols = a.lg_N - C_LG;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.batch << lg_cols) return;
  const long long row = idx >> lg_cols;
  const uint32_t r = idx & ((1u << lg_cols) - 1);
  const uint32_t u = r & ((1u << s0) - 1);
  const uint32_t base = u | ((r >> s0) << (s0 + C_LG));
  uint64_t* x = a.out + (row << a.lg_N) + base;
  uint64_t v[1 << C_LG];
#pragma unroll
  for (int q = 0; q < (1 << C_LG); ++q) v[q] = x[(size_t)q << s0];
  butterflies<C_LG>(v, a.tw, s0, u);
#pragma unroll
  for (int q = 0; q < (1 << C_LG); ++q)
    x[(size_t)q << s0] = kLast ? finish(a, v[q], base + (q << s0)) : v[q];
}


template <int C_LG, bool kLast>
void launch_columns(const Args& a, int s0, cudaStream_t st) {
  const long long threads = a.batch << (a.lg_N - C_LG);
  ntt_columns<C_LG, kLast>
      <<<(unsigned)((threads + kColThreads - 1) / kColThreads), kColThreads,
         0, st>>>(a, s0);
}

// the last column round: c stages from s0 = lg_N - c
void last_columns(const Args& a, int c, int s0, cudaStream_t st) {
  switch (c) {
    case 1: launch_columns<1, true>(a, s0, st); break;
    case 2: launch_columns<2, true>(a, s0, st); break;
    case 3: launch_columns<3, true>(a, s0, st); break;
    case 4: launch_columns<4, true>(a, s0, st); break;
    case 5: launch_columns<5, true>(a, s0, st); break;
    default: launch_columns<6, true>(a, s0, st); break;
  }
}

// the first of two column rounds: 3 to 5 stages from the tile
void first_columns(const Args& a, int c, int s0, cudaStream_t st) {
  switch (c) {
    case 3: launch_columns<3, false>(a, s0, st); break;
    case 4: launch_columns<4, false>(a, s0, st); break;
    default: launch_columns<5, false>(a, s0, st); break;
  }
}

// Runs the transform of `a`; writes the number of kernels launched.
// A tile of 2^kTileLg points takes 8 << kTileLg bytes of dynamic shared
// memory, above the 48 KiB default, so `ntt_tiles` needs the attribute set
// on every device it runs on: once for each device (the current one,
// `cudaGetDevice`), up to kMaxDevices; past that on every call.
constexpr int kMaxDevices = 64;

cudaError_t allow_tile_smem() {
  static std::atomic<bool> done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(ntt_tiles,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           8 << kTileLg);
  if (e == cudaSuccess && known) done[dev].store(true);
  return e;
}

int transform(Args a, void* stream, int* launches) {
  *launches = 0;
  if (a.batch <= 0) return 0;
  if (a.lg_N < 0 || a.lg_N > kMaxLg || a.rate < 0 || a.rate > a.lg_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.lg_N <= kRowLg) {
    const int bytes = 8 << a.lg_N;
    int threads = a.lg_N > 3 ? 1 << (a.lg_N - 3) : 32;
    threads = threads < 32 ? 32 : threads > kThreads ? kThreads : threads;
    ntt_row<<<(unsigned)a.batch, threads, bytes, st>>>(a);
    *launches = 1;
    return (int)cudaGetLastError();
  }
  // the largest tile below the row, shrunk while pass A has fewer than
  // kMinBlocks blocks; pass B's columns take the stages above it
  int lg_T = a.lg_N - 1 < kTileLg ? a.lg_N - 1 : kTileLg;
  int lowest = a.lg_N - kShrinkColLg > kMinTileLg ? a.lg_N - kShrinkColLg
                                                   : kMinTileLg;
  if (a.rate > lowest) lowest = a.rate;
  while (lg_T > lowest && (a.batch << (a.lg_N - lg_T)) < kMinBlocks) --lg_T;
  const int c = a.lg_N - lg_T;
  // kMaxLg - kTileLg = 11 stages above the tile at most: rounds of 5 + 6
  if (c > 2 * kMaxColLg - 1 || a.rate > lg_T)
    return (int)cudaErrorInvalidValue;
  a.lg_T = lg_T;
  const cudaError_t set = allow_tile_smem();
  if (set != cudaSuccess) return (int)set;
  const int threads = lg_T - 3 < 9 ? 1 << (lg_T - 3) : kThreads;
  ntt_tiles<<<(unsigned)(a.batch << c), threads, 8 << lg_T, st>>>(a);
  *launches = 1;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (c > kMaxColLg) {
    // two column rounds, the smaller first
    const int c1 = c / 2;
    first_columns(a, c1, lg_T, st);
    *launches = 2;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    last_columns(a, c - c1, lg_T + c1, st);
    *launches = 3;
    return (int)cudaGetLastError();
  }
  last_columns(a, c, lg_T, st);
  *launches = 2;
  return (int)cudaGetLastError();
}

}  // namespace

// out [batch, 2^(lg_n + rate_bits)] = the (coset) LDE of the rows of `in`
// (row b at in + b * in_stride elements, 2^lg_n canonical coefficients):
// shift_powers [2^lg_n] (or null for the subgroup itself), tw the forward
// stage-major table of 2^(lg_n + rate_bits) entries.
extern "C" int ntt_forward(void* out, const void* in, long long in_stride,
                           long long batch, int lg_n, int rate_bits,
                           const void* shift_powers, const void* tw,
                           void* stream, int* launches) {
  Args a{static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
         static_cast<const uint64_t*>(tw),
         static_cast<const uint64_t*>(shift_powers), nullptr, in_stride,
         batch, lg_n + rate_bits, rate_bits, 0};
  return transform(a, stream, launches);
}

// out [batch, 2^lg_n] = the coefficients of the canonical values `in`
// [batch, 2^lg_n]: scale [2^lg_n] = shift^(-i) / n, tw_inv the inverse
// root's stage-major table of 2^lg_n entries.
extern "C" int ntt_inverse(void* out, const void* in, long long batch,
                           int lg_n, const void* scale, const void* tw_inv,
                           void* stream, int* launches) {
  Args a{static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
         static_cast<const uint64_t*>(tw_inv), nullptr,
         static_cast<const uint64_t*>(scale), 1LL << lg_n, batch, lg_n, 0,
         0};
  return transform(a, stream, launches);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
