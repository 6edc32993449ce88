/* Goldilocks arithmetic on canonical values, for the host C library
 * (host_poseidon.c, witness_tape.c): each operation returns a canonical
 * value. Also declares the PoseidonGate witness trace that both use. */

#ifndef HOST_GOLDILOCKS_H
#define HOST_GOLDILOCKS_H

#include <stdint.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

#define ORDER 0xFFFFFFFF00000001ULL
#define EPSILON 0xFFFFFFFFULL

/* Branch-free: the witness trace and the challenger hash values no branch
 * predictor can learn, so each conditional step is a mask. */
static inline u64 mask_if(int c) { return (u64)0 - (u64)c; }

static inline u64 reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 hi_lo = hi & EPSILON;        /* hi mod 2^32 */
    u64 hi_hi = hi >> 32;            /* hi div 2^32 */
    /* x = lo + hi_lo*2^64 + hi_hi*2^96; 2^64 = EPSILON, 2^96 = -1 (mod p) */
    u64 t0;
    int borrow = __builtin_sub_overflow(lo, hi_hi, &t0);
    t0 -= EPSILON & mask_if(borrow); /* wrapping borrow correction */
    u64 t1 = hi_lo * EPSILON;
    u64 r;
    int carry = __builtin_add_overflow(t0, t1, &r);
    r += EPSILON & mask_if(carry);   /* carry correction */
    return r - (ORDER & mask_if(r >= ORDER));
}

static inline u64 gl_mul(u64 a, u64 b) { return reduce128((u128)a * b); }

static inline u64 gl_add(u64 a, u64 b) {
    u64 s;
    int carry = __builtin_add_overflow(a, b, &s);
    s += EPSILON & mask_if(carry);   /* wrapped past 2^64 */
    return s - (ORDER & mask_if(s >= ORDER));
}

static inline u64 gl_sub(u64 a, u64 b) {   /* canonical inputs */
    return a - b + (ORDER & mask_if(a < b));
}

/* The PoseidonGate's 135 wire values (gates/poseidon_gate.py layout) for 12
 * inputs and the swap bit (host_poseidon.c). */
void poseidon_generator_trace(const u64 *in12, u64 swap, u64 *w);

#endif
