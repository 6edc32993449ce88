// Goldilocks (p = 2^64 - 2^32 + 1) on values anywhere in [0, 2^64): the
// arithmetic of every kernel (the NTT, Poseidon and Poseidon2).
//
// Every function is a PTX carry chain on 32-bit limbs: a product is four
// partial products, and a 128-bit result is reduced through the carry flag
// with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), with no compares or selects.
// Every multiply and reduction takes any 64-bit operands and returns a
// value below 2^64, not always below p; a kernel makes a value canonical
// once, where it leaves the kernel. Sums of small-constant products are
// taken on the 32-bit halves in two 64-bit accumulators (`mad_wide`) and
// reduced once (`reduce_lh`); sums of general products accumulate the
// 128-bit products in 160 bits (`mac`) and reduce once (`reduce160`).
// tests/test_torch_poseidon.py holds a python-int model of each function.
#pragma once
#include <cstdint>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;

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

// a + b mod p for any a, b < 2^64; the result is < 2^64. A carry out of
// a + b is taken back as 2^64 = 2^32 - 1; adding that can carry once more
// (only when a + b >= 2^65 - 2^32 + 1), and the second 2^32 - 1 cannot
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, m;\n\t"
      "mov.b64 {a0, a1}, %2;\n\t"
      "mov.b64 {b0, b1}, %3;\n\t"
      "add.cc.u32 %0, a0, b0;\n\t"
      "addc.cc.u32 %1, a1, b1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "l"(a), "l"(b));
  return pack(r0, r1);
}

// a - b mod p for any a, b < 2^64; the result is < 2^64. A borrow out of
// a - b left 2^64 = 2^32 - 1 too much, taken off; that can borrow once
// more (only when the difference came out below 2^32 - 1), and the second
// 2^32 - 1 cannot
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, m;\n\t"
      "mov.b64 {a0, a1}, %2;\n\t"
      "mov.b64 {b0, b1}, %3;\n\t"
      "sub.cc.u32 %0, a0, b0;\n\t"
      "subc.cc.u32 %1, a1, b1;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "l"(a), "l"(b));
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

// x^7 as x^4 x^3: three multiplies deep; the S-box of both permutations
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul(x, x);
  const uint64_t x3 = mul(x2, x);
  const uint64_t x4 = mul(x2, x2);
  return mul(x4, x3);
}

}  // namespace
