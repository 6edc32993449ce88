// The kernels of the width-12 overwrite sponge (rate 8, 4-element digests)
// over a permutation: the batch permutation, the leaf sponge hash_no_pad
// over each column of [L, n], and the Merkle tree above the leaf digests.
// poseidon.cu and poseidon2.cu instantiate them on their permutation.
//
// A permutation is a struct `Perm` with
//   static constexpr int BLOCKS_PER_SM;      blocks of THREADS resident on
//                                            an SM at its register count
//   static constexpr long long LANE_LEAVES;  leaf batches of at most this
//                                            many columns take the 16-lane
//                                            sponge (0: never)
//   struct Lane;                             a lane's constants for
//   static Lane lane(int l);                 permute_lanes
//   static void permute(uint64_t s[W]);      one state in one thread
//   static uint64_t permute_lanes(uint64_t x, int l, const Lane&);
//                                            one state over the 16 lanes of
//                                            a group, lane l < 12 holding
//                                            s[l]; every lane of the warp
//                                            calls it
// all device functions, taking values anywhere in [0, 2^64) and returning
// values below 2^64, made canonical here where they leave the kernel.
//
// - The batch permutation and the leaf sponge run one state per thread, the
//   state in registers, each thread looping over its share of the batch in
//   whole waves of the resident blocks (`grid_for`). The leaf sponge reads
//   column i with thread i, so a warp reads consecutive addresses, and loads
//   the next chunk of eight elements before the current permutation runs.
// - Leaf batches too narrow to fill the card (the FRI leaves) can run the
//   sponge on 16 lanes a column, whose permutation's latency is a fraction
//   of one thread's.
// - The tree: a block builds a subtree of up to 2^10 leaves in shared
//   memory, level by level, writing every node into one buffer at fixed
//   offsets (layer l at row N - N / 2^(l-1)); at most 2^7 such blocks, so
//   the card holds them at once, then one block takes their roots down to
//   the cap. The upper levels have too few permutations to fill the card,
//   so their time is one permutation's latency: those levels run on
//   `permute_lanes`.
#pragma once
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

#include "goldilocks_lazy.cuh"

namespace {

constexpr int W = 12;
constexpr int RATE = 8;
constexpr int DIGEST = 4;
constexpr int THREADS = 128;
constexpr int LANES = 16;               // a lane group holds one state
constexpr int TREE_THREADS = 256;
constexpr int TREE_LG_ONE_BLOCK = 10;   // at most 2^10 inputs in a block
constexpr int TREE_LG_TOP = 7;          // the last launch takes 2^7 roots

template <class Perm>
__global__ void __launch_bounds__(THREADS, Perm::BLOCKS_PER_SM)
    permute_kernel(const uint64_t* __restrict__ in,
                   uint64_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < n; b += stride) {
    uint64_t s[W];
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = in[b * W + i];
    Perm::permute(s);
#pragma unroll
    for (int i = 0; i < W; ++i) out[b * W + i] = canonical(s[i]);
  }
}

template <class Perm>
__global__ void __launch_bounds__(THREADS, Perm::BLOCKS_PER_SM)
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
      Perm::permute(s);
    }
#pragma unroll
    for (int k = 0; k < DIGEST; ++k) out[col * DIGEST + k] = canonical(s[k]);
  }
}

// The leaf sponge on 16 lanes a column: lane k < 8 loads element k of each
// chunk, the next chunk before the current permutation runs. Exactly
// ceil(16 n / THREADS) blocks, so every lane of a warp runs the same rounds
// (a group past the last column computes what is ignored).
template <class Perm>
__global__ void __launch_bounds__(THREADS)
    hash_leaves_lanes_kernel(const uint64_t* __restrict__ x,
                             uint64_t* __restrict__ out, int L, long long n) {
  const int lane = threadIdx.x % LANES;
  const long long col =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const bool live = col < n;
  const typename Perm::Lane c = Perm::lane(lane);
  uint64_t s = 0;
  uint64_t next = live && lane < RATE && lane < L
                      ? __ldg(x + (long long)lane * n + col) : 0;
  for (int start = 0; start < L; start += RATE) {
    if (lane < L - start && lane < RATE) s = next;
    const int k = start + RATE + lane;
    if (live && lane < RATE && k < L) next = __ldg(x + (long long)k * n + col);
    s = Perm::permute_lanes(s, lane, c);
  }
  if (live && lane < DIGEST) out[col * DIGEST + lane] = canonical(s);
}

// Offset, in digests, of tree layer `level` (>= 1) in the buffer of a tree
// with n leaves: layers 1, 2, ... are stored one after another.
__device__ __forceinline__ long long layer_offset(long long n, int level) {
  return n - (n >> (level - 1));
}

// Block b takes inputs [b 2^lg_in, (b + 1) 2^lg_in) of layer `level0` (the
// leaves for 0) and builds `levels` layers above them in shared memory, two
// buffers used in turn, writing each node to its place in `out`. A level
// whose permutations fill at most two passes of the block's lane groups
// runs them on `permute_lanes`; a larger one runs one permutation per
// thread on `permute`.
template <class Perm>
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
  const typename Perm::Lane c = Perm::lane(lane);
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
        x = Perm::permute_lanes(x, lane, c);
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
        Perm::permute(s);
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

// The SM count of the current device (`cudaGetDevice`), looked up once for
// each device up to MAX_DEVICES, on every call past that.
constexpr int MAX_DEVICES = 64;

inline int sm_count() {
  static std::atomic<int> counts[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const bool known = dev >= 0 && dev < MAX_DEVICES;
  int sms = known ? counts[dev].load() : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
    if (known) counts[dev].store(sms);
  }
  return sms;
}

// Blocks for n threads of THREADS: Perm::BLOCKS_PER_SM on each SM at most,
// each thread looping over its share, in whole waves of the resident
// threads so that no wave runs part-empty.
template <class Perm>
unsigned grid_for(long long n) {
  const long long slots = (long long)sm_count() * Perm::BLOCKS_PER_SM *
                          THREADS;
  const long long waves = (n + slots - 1) / slots;
  return (unsigned)((n + waves * THREADS - 1) / (waves * THREADS));
}

// states_in, states_out: [n, 12] contiguous; any n.
template <class Perm>
int launch_permute(const void* states_in, void* states_out, long long n,
                   void* stream) {
  if (n <= 0) return 0;
  permute_kernel<Perm><<<grid_for<Perm>(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(states_in),
      static_cast<uint64_t*>(states_out), n);
  return (int)cudaGetLastError();
}

// x: [L, n] contiguous (column i is leaf i); out: [n, 4] digests of the
// overwrite-mode sponge hash_no_pad over each column.
template <class Perm>
int launch_hash_leaves(const void* x, void* out, int L, long long n,
                       void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* in = static_cast<const uint64_t*>(x);
  uint64_t* dst = static_cast<uint64_t*>(out);
  if constexpr (Perm::LANE_LEAVES > 0) {
    if (n <= Perm::LANE_LEAVES) {
      hash_leaves_lanes_kernel<Perm>
          <<<(unsigned)((n * LANES + THREADS - 1) / THREADS), THREADS, 0,
             st>>>(in, dst, L, n);
      return (int)cudaGetLastError();
    }
  }
  hash_leaves_kernel<Perm><<<grid_for<Perm>(n), THREADS, 0, st>>>(in, dst,
                                                                   L, n);
  return (int)cudaGetLastError();
}

// leaves: [n, 4] digests, n a power of two; out: [n - 2^cap_height, 4], the
// layers above the leaves down to the cap, layer l at row
// n - n / 2^(l-1). Subtrees of up to 2^10 leaves, at most 2^7 of them (one
// block each, which the card holds at once), then one block from their
// roots to the cap: two launches up to 2^17 leaves, one up to 2^7. Writes
// the number of kernels launched to *launches.
template <class Perm>
int launch_merkle_tree(const void* leaves, void* out, long long n,
                       int cap_height, void* stream, int* launches) {
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
    merkle_kernel<Perm><<<(unsigned)(1LL << (lg_layer - lg_in)),
                          TREE_THREADS, smem,
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

}  // namespace
