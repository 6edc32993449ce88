// Goldilocks and quadratic-extension elementwise arithmetic: one launch for
// each operation of field/goldilocks.py and field/extension.py on CUDA
// tensors.
//
// Replaces no Pallas kernel: the JAX package's field arithmetic is jnp
// (plonky2_tpu/field/goldilocks.py), which XLA fused into the code around
// it. PyTorch has no uint64 arithmetic, so the plain version emulates each
// operation on 32-bit halves held in int64, a chain of some 30 (add, sub)
// to 95 (mul) aten launches that each write a full-size intermediate.
//
// Bound: bytes, device memory at 3.35 TB/s. A multiply reads 16 bytes and
// writes 8 against some 30 integer instructions, an extension multiply
// reads 32 and writes 16 against some 120; `exp` by a 64-bit exponent is
// the exception, up to 128 multiplies an element, bound by operations.
//
// Design:
// - One thread an output element, in a grid-stride loop with 64-bit
//   indices; every intermediate in registers, on the carry-chain
//   arithmetic of goldilocks_lazy.cuh, made canonical once on the way out.
//   Every operation is exact mod p for any 64-bit operands, so the output
//   equals the plain version's bit for bit, non-canonical inputs included.
// - Operands broadcast by strides inside the kernel: the wrapper passes the
//   output's shape, with size-1 dims dropped and neighbours merged wherever
//   every operand steps through them as one (at most kMaxDims left), and
//   each operand's element strides, 0 on a broadcast dim. No expanded
//   operand is made and no view is copied.
// - An operand that is one host value (a CPU 0-d tensor, a constant, the
//   exponent) travels in the kernel's arguments, never uploaded.
// - The output index is split into dims in 32-bit arithmetic when the
//   output has fewer than 2^32 elements (a 64-bit division is a long
//   software routine), in 64-bit otherwise.
// - The plan is one __grid_constant__ argument, read in place from the
//   parameter bank. The wrapper packs it as bytes: the host's time a call
//   (PERF.md) is what a small operation costs.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "goldilocks_lazy.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;
constexpr uint64_t kW = 7;   // the extension's X^2 = 7

// the entries' op codes: field/goldilocks.py BINARY_OPS, EXT_OPS
enum { kAdd = 0, kSub = 1, kMul = 2, kExp = 3, kReduceLH = 4 };

struct Operand {
  const uint64_t* ptr;   // null: `value` in every element
  uint64_t value;
  long long stride[kMaxDims];
};

template <int N>
struct Plan {
  long long n;                  // output elements
  int nd;                       // dims, innermost last
  long long shape[kMaxDims];
  Operand x[N];
};

// the plan as the wrapper packs it, 64-bit words in host order: n, nd,
// shape[kMaxDims], then for each operand its pointer, its value and
// stride[kMaxDims]
template <int N>
Plan<N> read_plan(const char* bytes) {
  long long w[2 + kMaxDims + N * (2 + kMaxDims)];
  std::memcpy(w, bytes, sizeof(w));
  Plan<N> p;
  p.n = w[0];
  p.nd = static_cast<int>(w[1]);
  for (int d = 0; d < kMaxDims; ++d) p.shape[d] = w[2 + d];
  const long long* o = w + 2 + kMaxDims;
  for (int k = 0; k < N; ++k, o += 2 + kMaxDims) {
    p.x[k].ptr = reinterpret_cast<const uint64_t*>(o[0]);
    p.x[k].value = static_cast<uint64_t>(o[1]);
    for (int d = 0; d < kMaxDims; ++d) p.x[k].stride[d] = o[2 + d];
  }
  return p;
}

// the operands' elements at output index i
template <class Idx, int N>
__device__ __forceinline__ void load(const Plan<N>& p, long long i,
                                     uint64_t v[N]) {
  long long off[N];
#pragma unroll
  for (int k = 0; k < N; ++k) off[k] = 0;
  Idx rest = static_cast<Idx>(i);
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < p.nd) {
      const Idx size = static_cast<Idx>(p.shape[d]);
      const Idx q = rest / size;
      const long long r = static_cast<long long>(rest - q * size);
#pragma unroll
      for (int k = 0; k < N; ++k) off[k] += r * p.x[k].stride[d];
      rest = q;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    off[k] += static_cast<long long>(rest) * p.x[k].stride[0];
    v[k] = p.x[k].ptr ? p.x[k].ptr[off[k]] : p.x[k].value;
  }
}

// a^e by square-and-multiply from the low bit; a^0 = 1, so 0^0 = 1 and
// 0^(p-2) = 0
__device__ __forceinline__ uint64_t exp_u64(uint64_t a, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = mul(r, a);
    e >>= 1;
    if (e) a = mul(a, a);
  }
  return r;
}

template <int Op, class Idx>
__global__ void __launch_bounds__(kThreads)
    field_binary_kernel(uint64_t* out, const __grid_constant__ Plan<2> p) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < p.n; i += step) {
    uint64_t v[2];
    load<Idx>(p, i, v);
    uint64_t r;
    if constexpr (Op == kAdd) r = add_lazy(v[0], v[1]);
    else if constexpr (Op == kSub) r = sub_lazy(v[0], v[1]);
    else if constexpr (Op == kMul) r = mul(v[0], v[1]);
    else if constexpr (Op == kExp) r = exp_u64(v[0], v[1]);
    else r = reduce_lh(v[0], v[1]);   // L + H 2^32, H < 2^64 - 2^32
    out[i] = canonical(r);
  }
}

// (a0 + a1 X) op (b0 + b1 X) over X^2 = 7, both limbs out of one thread;
// the products sum in 160 bits and reduce once a limb
template <int Op, class Idx>
__global__ void __launch_bounds__(kThreads)
    field_ext_kernel(uint64_t* out0, uint64_t* out1,
                     const __grid_constant__ Plan<4> p) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < p.n; i += step) {
    uint64_t v[4];   // a0, a1, b0, b1
    load<Idx>(p, i, v);
    uint64_t c0, c1;
    if constexpr (Op == kAdd) {
      c0 = add_lazy(v[0], v[2]);
      c1 = add_lazy(v[1], v[3]);
    } else if constexpr (Op == kSub) {
      c0 = sub_lazy(v[0], v[2]);
      c1 = sub_lazy(v[1], v[3]);
    } else {
      uint32_t acc[5] = {0, 0, 0, 0, 0};
      mac(acc, v[0], v[2]);
      mac(acc, mul(v[1], v[3]), kW);
      c0 = reduce160(acc);
      uint32_t acc1[5] = {0, 0, 0, 0, 0};
      mac(acc1, v[0], v[3]);
      mac(acc1, v[1], v[2]);
      c1 = reduce160(acc1);
    }
    out0[i] = canonical(c0);
    out1[i] = canonical(c1);
  }
}

unsigned blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <int N>
bool valid(const Plan<N>& p) {
  return p.n > 0 && p.nd >= 1 && p.nd <= kMaxDims;
}

template <int Op>
void launch_binary(uint64_t* out, const Plan<2>& p, cudaStream_t st) {
  if (p.n <= 0xFFFFFFFFLL)
    field_binary_kernel<Op, uint32_t><<<blocks(p.n), kThreads, 0, st>>>(
        out, p);
  else
    field_binary_kernel<Op, uint64_t><<<blocks(p.n), kThreads, 0, st>>>(
        out, p);
}

template <int Op>
void launch_ext(uint64_t* out0, uint64_t* out1, const Plan<4>& p,
                cudaStream_t st) {
  if (p.n <= 0xFFFFFFFFLL)
    field_ext_kernel<Op, uint32_t><<<blocks(p.n), kThreads, 0, st>>>(
        out0, out1, p);
  else
    field_ext_kernel<Op, uint64_t><<<blocks(p.n), kThreads, 0, st>>>(
        out0, out1, p);
}

}  // namespace

// out [n] (contiguous, the broadcast shape) = x0 op x1 over the plan's two
// operands: add, sub, mul, exp (x0^x1) or reduce_lh ((x0 + x1 2^32) mod p)
extern "C" int field_binary(int op, void* out, const char* plan,
                            void* stream) {
  const Plan<2> p = read_plan<2>(plan);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  uint64_t* o = static_cast<uint64_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: launch_binary<kAdd>(o, p, st); break;
    case kSub: launch_binary<kSub>(o, p, st); break;
    case kMul: launch_binary<kMul>(o, p, st); break;
    case kExp: launch_binary<kExp>(o, p, st); break;
    case kReduceLH: launch_binary<kReduceLH>(o, p, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// (out0, out1) [n] = (a0 + a1 X) op (b0 + b1 X), the plan's operands a0,
// a1, b0, b1: add, sub or mul
extern "C" int field_ext(int op, void* out0, void* out1, const char* plan,
                         void* stream) {
  const Plan<4> p = read_plan<4>(plan);
  if (!valid(p) || op < kAdd || op > kMul)
    return static_cast<int>(cudaErrorInvalidValue);
  uint64_t* o0 = static_cast<uint64_t*>(out0);
  uint64_t* o1 = static_cast<uint64_t*>(out1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == kAdd) launch_ext<kAdd>(o0, o1, p, st);
  else if (op == kSub) launch_ext<kSub>(o0, o1, p, st);
  else launch_ext<kMul>(o0, o1, p, st);
  return static_cast<int>(cudaGetLastError());
}
