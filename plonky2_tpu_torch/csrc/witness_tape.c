/* The witness tape: the lowered steps of a recorded witness plan
 * (iop/tape.py), run in order over the typed witness store of
 * iop/witness.py (one canonical uint64 value and one set flag a
 * representative, and the order in which representatives were set).
 *
 * An op is [opcode, n_deps, n_consts, n_outs, deps..., consts..., outs...]:
 * the representatives it reads, its build-time constants (canonical), and
 * the representatives it writes, in the order the generator's `run_once`
 * emits them. Each op computes what its generator's `run_once` computes,
 * bit for bit, and writes as `PartitionWitness.set_rep` does: an unset
 * representative is set and appended to the order, a set one must hold
 * the same value.
 */

#include <stdint.h>
#include <stddef.h>

#include "host_goldilocks.h"

#define TAPE_POSEIDON 1
#define TAPE_ARITHMETIC 2
#define TAPE_ARITHMETIC_EXT 3
#define TAPE_MUL_EXT 4
#define TAPE_REDUCING 5
#define TAPE_REDUCING_EXT 6
#define TAPE_RANDOM_ACCESS 7

#define TAPE_OK 0
#define TAPE_NOT_READY 1        /* a dependency is unset */
#define TAPE_CONFLICT 2         /* an output is set to another value */
#define TAPE_REFUSED 3          /* the generator's own check fails */

#define TAPE_MAX 512            /* deps or outs of one op (iop/tape.py) */
#define EXT_W 7                 /* F[X]/(X^2 - 7) */

/* PoseidonGate trace columns in its generator's order: the deltas, the
 * S-box inputs (25..135), then the outputs (12..24) */
#define POSEIDON_OUTS 122

static inline void ext_mul(u64 a0, u64 a1, u64 b0, u64 b1, u64 *c) {
    c[0] = gl_add(gl_mul(a0, b0), gl_mul(EXT_W, gl_mul(a1, b1)));
    c[1] = gl_add(gl_mul(a0, b1), gl_mul(a1, b0));
}

/* The outputs of one op from its inputs; TAPE_OK or TAPE_REFUSED. */
static int compute(u64 opcode, const u64 *in, size_t nd, const u64 *c,
                   size_t no, u64 *res) {
    u64 p[2];
    switch (opcode) {
    case TAPE_POSEIDON: {
        u64 trace[135];
        if (nd != 13 || no != POSEIDON_OUTS || in[12] > 1)
            return TAPE_REFUSED;
        poseidon_generator_trace(in, in[12], trace);
        for (int i = 0; i < 110; i++) res[i] = trace[25 + i];
        for (int i = 0; i < 12; i++) res[110 + i] = trace[12 + i];
        return TAPE_OK;
    }
    case TAPE_ARITHMETIC:
        res[0] = gl_add(gl_mul(gl_mul(c[0], in[0]), in[1]),
                        gl_mul(c[1], in[2]));
        return TAPE_OK;
    case TAPE_ARITHMETIC_EXT:
        ext_mul(in[0], in[1], in[2], in[3], p);
        res[0] = gl_add(gl_mul(p[0], c[0]), gl_mul(in[4], c[1]));
        res[1] = gl_add(gl_mul(p[1], c[0]), gl_mul(in[5], c[1]));
        return TAPE_OK;
    case TAPE_MUL_EXT:
        ext_mul(in[0], in[1], in[2], in[3], p);
        res[0] = gl_mul(p[0], c[0]);
        res[1] = gl_mul(p[1], c[0]);
        return TAPE_OK;
    case TAPE_REDUCING:         /* alpha, old acc, base coefficients */
    case TAPE_REDUCING_EXT: {   /* alpha, old acc, extension coefficients */
        int ext = opcode == TAPE_REDUCING_EXT;
        size_t n = ext ? (nd - 4) / 2 : nd - 4;
        u64 acc0 = in[2], acc1 = in[3];
        for (size_t i = 0; i < n; i++) {
            ext_mul(acc0, acc1, in[0], in[1], p);
            acc0 = gl_add(p[0], in[4 + (ext ? 2 * i : i)]);
            acc1 = ext ? gl_add(p[1], in[5 + 2 * i]) : p[1];
            res[2 * i] = acc0;
            res[2 * i + 1] = acc1;
        }
        return TAPE_OK;
    }
    case TAPE_RANDOM_ACCESS: {  /* index, the list; claimed, the bits */
        u64 idx = in[0];
        if (idx >= nd - 1)
            return TAPE_REFUSED;
        res[0] = in[1 + idx];
        for (size_t i = 0; i + 1 < no; i++) res[1 + i] = (idx >> i) & 1;
        return TAPE_OK;
    }
    }
    return TAPE_REFUSED;
}

/* Runs `n_ops` ops of `tape`; returns how many completed. Where one did
 * not, `*status` says why (TAPE_NOT_READY before any write; TAPE_CONFLICT
 * after the writes before the conflicting one; TAPE_REFUSED before any
 * write). `*len` is the count of set representatives in `order`, in and
 * out. */
int64_t witness_tape_run(const u64 *tape, int64_t n_ops, u64 *values,
                         uint8_t *flags, int64_t *order, int64_t *len,
                         int32_t *status) {
    u64 in[TAPE_MAX], res[TAPE_MAX];
    int64_t n = *len;
    *status = TAPE_OK;
    for (int64_t k = 0; k < n_ops; k++) {
        u64 opcode = tape[0];
        size_t nd = tape[1], nc = tape[2], no = tape[3];
        const u64 *deps = tape + 4, *consts = deps + nd, *outs = consts + nc;
        if (nd > TAPE_MAX || no > TAPE_MAX) {
            *status = TAPE_REFUSED;
            return k;
        }
        for (size_t i = 0; i < nd; i++) {
            if (!flags[deps[i]]) {
                *status = TAPE_NOT_READY;
                return k;
            }
            in[i] = values[deps[i]];
        }
        int s = compute(opcode, in, nd, consts, no, res);
        if (s != TAPE_OK) {
            *status = s;
            return k;
        }
        for (size_t i = 0; i < no; i++) {
            u64 r = outs[i];
            if (flags[r]) {
                if (values[r] != res[i]) {
                    *len = n;
                    *status = TAPE_CONFLICT;
                    return k;
                }
            } else {
                values[r] = res[i];
                flags[r] = 1;
                order[n++] = (int64_t)r;
            }
        }
        *len = n;
        tape = outs + no;
    }
    return n_ops;
}

/* The wire matrix's slice of one witness (iop/witness.py wire_matrix):
 * each set representative's value, in `order`, to each of its wire slots
 * (slot w * degree + i of representative r in rep_slots[rep_starts[r] ..
 * rep_starts[r + 1]]), at [w, b, i] of out, uint64 [num_wires, batch,
 * degree]; degree is 2^log_degree. Slots of no set representative are
 * left as they are. */
void wire_matrix_fill(const u64 *values, const int64_t *order, int64_t n_set,
                      const int64_t *rep_starts, const int64_t *rep_slots,
                      int64_t log_degree, int64_t batch, int64_t b,
                      u64 *out) {
    const int64_t mask = ((int64_t)1 << log_degree) - 1;
    for (int64_t k = 0; k < n_set; k++) {
        int64_t r = order[k];
        u64 v = values[r];
        for (int64_t j = rep_starts[r]; j < rep_starts[r + 1]; j++) {
            int64_t s = rep_slots[j];
            int64_t w = s >> log_degree;
            out[((w * batch + b) << log_degree) + (s & mask)] = v;
        }
    }
}
