// Goldilocks field (p = 2^64 - 2^32 + 1) on uint64_t, canonical in and out.
// Same reduction schedule as the reference's reduce128
// (field/src/goldilocks_field.rs); every result is < p because the port
// compares bit patterns.
#pragma once
#include <cstdint>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) return s + GL_EPS;  // wrapped past 2^64: s + 2^64 - p < p
  return s >= GL_P ? s - GL_P : s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d + GL_P : d;  // wraps back to a - b + p
}

// (hi * 2^64 + lo) mod p, using 2^64 = EPS and 2^96 = -1 (mod p).
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32, hi_lo = hi & GL_EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= GL_EPS;
  uint64_t t1 = hi_lo * GL_EPS;
  uint64_t r = t0 + t1;
  if (r < t1) r += GL_EPS;
  return r >= GL_P ? r - GL_P : r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}
