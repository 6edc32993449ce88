/* Host Poseidon and Poseidon2 permutations over Goldilocks, in C for the
 * CPU.
 *
 * The host's hot paths are the PoseidonGate witness trace (one full
 * permutation per gate row, in the witness fixpoint), the Fiat-Shamir
 * challenger, and the FRI proof-of-work grind of a prover on the CPU. Built
 * with the host `cc` by plonky2_tpu_torch/host.py; the constants are emitted
 * at build time into poseidon_constants_gen.h from the port's
 * hash/poseidon_constants.py with the derived fast-partial-round tables
 * (hash/poseidon_fast.py), and from hash/poseidon2_constants.py.
 */

#include <stdint.h>
#include <stddef.h>

#include "host_goldilocks.h"
#include "poseidon_constants_gen.h"

#define WIDTH 12
#define N_ROUNDS 30
#define HALF_FULL 4
#define P2_ROUNDS_P 22

static inline u64 sbox(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x3 = gl_mul(x2, x);
    u64 x6 = gl_mul(x3, x3);
    return gl_mul(x6, x);
}

static void mds_layer(const u64 *in, u64 *out) {
    for (int r = 0; r < WIDTH; r++) {
        u128 acc = 0;
        for (int i = 0; i < WIDTH; i++)
            acc += (u128)MDS_CIRC[i] * in[(r + i) % WIDTH];
        acc += (u128)MDS_DIAG[r] * in[r];
        out[r] = reduce128(acc);
    }
}

void poseidon_permute(u64 *state) {
    u64 tmp[WIDTH];
    for (int round = 0; round < N_ROUNDS; round++) {
        int full = round < HALF_FULL || round >= N_ROUNDS - HALF_FULL;
        for (int i = 0; i < WIDTH; i++) {
            u64 x = gl_add(state[i], ROUND_CONSTANTS[round * WIDTH + i]);
            state[i] = (full || i == 0) ? sbox(x) : x;
        }
        mds_layer(state, tmp);
        for (int i = 0; i < WIDTH; i++) state[i] = tmp[i];
    }
}

void poseidon_permute_many(u64 *states, size_t count) {
    for (size_t k = 0; k < count; k++)
        poseidon_permute(states + k * WIDTH);
}

/* Poseidon2 (reference: poseidon2.rs:448-476): the external layer (three
 * apply_m_4 blocks plus the column sums of the blocks), 4 full rounds, 22
 * internal rounds on s[0] with s[i] * DIAG[i] + sum(s), 4 full rounds. */
static void p2_external_layer(u64 *s) {
    for (int b = 0; b < WIDTH; b += 4) {
        u64 t0 = gl_add(s[b], s[b + 1]), t1 = gl_add(s[b + 2], s[b + 3]);
        u64 t2 = gl_add(gl_add(s[b + 1], s[b + 1]), t1);
        u64 t3 = gl_add(gl_add(s[b + 3], s[b + 3]), t0);
        u64 t1x2 = gl_add(t1, t1), t0x2 = gl_add(t0, t0);
        u64 t4 = gl_add(gl_add(t1x2, t1x2), t3);
        u64 t5 = gl_add(gl_add(t0x2, t0x2), t2);
        s[b] = gl_add(t3, t5);
        s[b + 1] = t5;
        s[b + 2] = gl_add(t2, t4);
        s[b + 3] = t4;
    }
    for (int k = 0; k < 4; k++) {
        u64 sum = gl_add(gl_add(s[k], s[4 + k]), s[8 + k]);
        for (int b = 0; b < WIDTH; b += 4) s[b + k] = gl_add(s[b + k], sum);
    }
}

static void p2_full_round(u64 *s, int f) {
    for (int i = 0; i < WIDTH; i++)
        s[i] = sbox(gl_add(s[i], P2_FULL_RC[f * WIDTH + i]));
    p2_external_layer(s);
}

void poseidon2_permute(u64 *s) {
    p2_external_layer(s);
    for (int f = 0; f < HALF_FULL; f++) p2_full_round(s, f);
    for (int r = 0; r < P2_ROUNDS_P; r++) {
        s[0] = sbox(gl_add(s[0], P2_PARTIAL_RC[r]));
        u64 total = s[0];
        for (int i = 1; i < WIDTH; i++) total = gl_add(total, s[i]);
        for (int i = 0; i < WIDTH; i++)
            s[i] = gl_add(gl_mul(s[i], P2_DIAG[i]), total);
    }
    for (int f = HALF_FULL; f < 2 * HALF_FULL; f++) p2_full_round(s, f);
}

void poseidon2_permute_many(u64 *states, size_t count) {
    for (size_t k = 0; k < count; k++)
        poseidon2_permute(states + k * WIDTH);
}

/* ------------------------------------------------------------------------
 * PoseidonGate witness-generation trace (fast-partial-rounds formulation).
 *
 * The PLONK witness needs every committed intermediate of the FAST
 * formulation (reference: plonky2/src/gates/poseidon.rs generator :726-845),
 * not the naive schedule above: the committed S-box inputs differ between
 * the two even though the final permutation output is identical.
 *
 * Wire layout (gates/poseidon_gate.py): 0..12 inputs | 12..24 outputs |
 * 24 swap | 25..29 deltas | 29..65 full-round-0 sbox inputs |
 * 65..87 partial sbox inputs | 87..135 full-round-1 sbox inputs.
 * ---------------------------------------------------------------------- */

#define WIRE_SWAP 24
#define START_DELTA 25
#define START_FULL_0 29
#define START_PARTIAL 65
#define START_FULL_1 87
#define N_PARTIAL 22

void poseidon_generator_trace(const u64 *in12, u64 swap, u64 *w) {
    u64 state[WIDTH], tmp[WIDTH];
    for (int i = 0; i < WIDTH; i++) {
        u64 v = in12[i];
        if (v >= ORDER) v -= ORDER;
        w[i] = v;
        state[i] = v;
    }
    w[WIRE_SWAP] = swap;
    for (int i = 0; i < 4; i++) {
        u64 delta = swap ? gl_sub(state[i + 4], state[i]) : 0;
        w[START_DELTA + i] = delta;
        state[i] = gl_add(state[i], delta);
        state[i + 4] = gl_sub(state[i + 4], delta);
    }

    int round_ctr = 0;
    for (int r = 0; r < HALF_FULL; r++) {
        for (int i = 0; i < WIDTH; i++)
            state[i] = gl_add(state[i], ROUND_CONSTANTS[round_ctr * WIDTH + i]);
        if (r)
            for (int i = 0; i < WIDTH; i++)
                w[START_FULL_0 + WIDTH * (r - 1) + i] = state[i];
        for (int i = 0; i < WIDTH; i++) state[i] = sbox(state[i]);
        mds_layer(state, tmp);
        for (int i = 0; i < WIDTH; i++) state[i] = tmp[i];
        round_ctr++;
    }

    /* partial_first_constant_layer + mds_partial_layer_init (transposed) */
    for (int i = 0; i < WIDTH; i++)
        state[i] = gl_add(state[i], FAST_FIRST_RC[i]);
    tmp[0] = state[0];
    for (int c = 1; c < WIDTH; c++) {
        u64 acc = 0;
        for (int r = 1; r < WIDTH; r++)
            acc = gl_add(acc, gl_mul(state[r],
                                     FAST_INIT_MAT[(r - 1) * 11 + (c - 1)]));
        tmp[c] = acc;
    }
    for (int i = 0; i < WIDTH; i++) state[i] = tmp[i];

    const u64 m00 = (u64)MDS_CIRC[0] + (u64)MDS_DIAG[0];
    for (int r = 0; r < N_PARTIAL; r++) {
        w[START_PARTIAL + r] = state[0];
        u64 s0 = sbox(state[0]);
        s0 = gl_add(s0, FAST_PARTIAL_RC[r]);       /* last entry is 0 */
        u64 d = gl_mul(s0, m00);
        for (int i = 1; i < WIDTH; i++)
            d = gl_add(d, gl_mul(state[i], FAST_W_HATS[r * 11 + i - 1]));
        for (int i = 1; i < WIDTH; i++)
            state[i] = gl_add(state[i], gl_mul(s0, FAST_VS[r * 11 + i - 1]));
        state[0] = d;
    }
    round_ctr += N_PARTIAL;

    for (int r = 0; r < HALF_FULL; r++) {
        for (int i = 0; i < WIDTH; i++)
            state[i] = gl_add(state[i], ROUND_CONSTANTS[round_ctr * WIDTH + i]);
        for (int i = 0; i < WIDTH; i++)
            w[START_FULL_1 + WIDTH * r + i] = state[i];
        for (int i = 0; i < WIDTH; i++) state[i] = sbox(state[i]);
        mds_layer(state, tmp);
        for (int i = 0; i < WIDTH; i++) state[i] = tmp[i];
        round_ctr++;
    }
    for (int i = 0; i < WIDTH; i++) w[WIDTH + i] = state[i];
}
