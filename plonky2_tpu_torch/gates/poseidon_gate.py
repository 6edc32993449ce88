"""PoseidonGate — the width-12 permutation in one row of 135 wires
(reference gates/poseidon.rs — wire layout :42-99, constraints :418-500,
generator :726-845).

Wires: 0..12 inputs | 12..24 outputs | 24 swap | 25..29 deltas |
29..65 full-round-0 S-box inputs (rounds 1..3) | 65..87 partial S-box inputs
| 87..135 full-round-1 S-box inputs. Every S-box input is a committed wire,
so the constraint degree stays 7 across the 30 rounds.
"""

from __future__ import annotations

import torch

from .. import host
from ..field import goldilocks as gl
from ..field import reference as ref
from ..hash import poseidon as ps
from ..hash import poseidon_fast as pf
from ..hash.poseidon_constants import (
    HALF_N_FULL_ROUNDS, MDS_MATRIX_CIRC, MDS_MATRIX_DIAG, N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from ..iop import tape
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from .gate import Gate

W = SPONGE_WIDTH


class PoseidonGate(Gate):
    WIRE_SWAP = 2 * W
    START_DELTA = 2 * W + 1
    START_FULL_0 = START_DELTA + 4
    START_PARTIAL = START_FULL_0 + (HALF_N_FULL_ROUNDS - 1) * W
    START_FULL_1 = START_PARTIAL + N_PARTIAL_ROUNDS

    @staticmethod
    def wire_input(i):
        return i

    @staticmethod
    def wire_output(i):
        return W + i

    @classmethod
    def wire_delta(cls, i):
        assert i < 4
        return cls.START_DELTA + i

    @classmethod
    def wire_full_sbox_0(cls, round_, i):
        assert 0 < round_ < HALF_N_FULL_ROUNDS
        return cls.START_FULL_0 + W * (round_ - 1) + i

    @classmethod
    def wire_partial_sbox(cls, round_):
        return cls.START_PARTIAL + round_

    @classmethod
    def wire_full_sbox_1(cls, round_, i):
        return cls.START_FULL_1 + W * round_ + i

    def id(self):
        return ("PoseidonGate(PhantomData<plonky2_field::goldilocks_field::"
                "GoldilocksField>)<WIDTH=12>")

    def num_wires(self):
        return self.START_FULL_1 + HALF_N_FULL_ROUNDS * W  # 135

    def degree(self):
        return 7

    def num_constraints(self):
        return (1 + 4 + (HALF_N_FULL_ROUNDS - 1) * W + N_PARTIAL_ROUNDS
                + HALF_N_FULL_ROUNDS * W + W)  # 123

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        cons = []
        one = alg.const(1)
        swap = wires[self.WIRE_SWAP]
        cons.append(alg.mul(swap, alg.sub(swap, one)))
        for i in range(4):
            lhs = wires[self.wire_input(i)]
            rhs = wires[self.wire_input(i + 4)]
            delta = wires[self.wire_delta(i)]
            cons.append(alg.sub(alg.mul(swap, alg.sub(rhs, lhs)), delta))

        state = [None] * W
        for i in range(4):
            delta = wires[self.wire_delta(i)]
            state[i] = alg.add(wires[self.wire_input(i)], delta)
            state[i + 4] = alg.sub(wires[self.wire_input(i + 4)], delta)
        for i in range(8, W):
            state[i] = wires[self.wire_input(i)]

        round_ctr = 0
        for r in range(HALF_N_FULL_ROUNDS):
            state = pf.constant_layer(alg, state, round_ctr)
            if r != 0:
                for i in range(W):
                    sbox_in = wires[self.wire_full_sbox_0(r, i)]
                    cons.append(alg.sub(state[i], sbox_in))
                    state[i] = sbox_in
            state = pf.sbox_layer(alg, state)
            state = pf.mds_layer(alg, state)
            round_ctr += 1

        partial_rc = pf.fast_partial_tables()[1]
        state = pf.partial_first_constant_layer(alg, state)
        state = pf.mds_partial_layer_init(alg, state)
        for r in range(N_PARTIAL_ROUNDS):
            sbox_in = wires[self.wire_partial_sbox(r)]
            cons.append(alg.sub(state[0], sbox_in))
            s0 = pf.sbox_monomial(alg, sbox_in)
            if r < N_PARTIAL_ROUNDS - 1:
                s0 = alg.add_const(s0, partial_rc[r])
            state = [s0] + state[1:]
            state = pf.mds_partial_layer_fast(alg, state, r)
        round_ctr += N_PARTIAL_ROUNDS

        for r in range(HALF_N_FULL_ROUNDS):
            state = pf.constant_layer(alg, state, round_ctr)
            for i in range(W):
                sbox_in = wires[self.wire_full_sbox_1(r, i)]
                cons.append(alg.sub(state[i], sbox_in))
                state[i] = sbox_in
            state = pf.sbox_layer(alg, state)
            state = pf.mds_layer(alg, state)
            round_ctr += 1

        for i in range(W):
            cons.append(alg.sub(state[i], wires[self.wire_output(i)]))
        return cons

    def eval_unfiltered_rows(self, consts_rows, wires_rows, pi_rows):
        """The same constraints, in the same order, on the lanes-layout
        state [12, N] with a Python loop over the rounds."""
        t = ps._tables(wires_rows.device)
        full = lambda s: gl.mat_small(t["mds"], ps._sbox(s))
        cons = []
        swap = wires_rows[self.WIRE_SWAP]
        cons.append(gl.mul(swap, gl.sub(swap, gl.const(1, swap.device))))
        ins = wires_rows[:W]
        deltas = wires_rows[self.START_DELTA:self.START_DELTA + 4]
        cons.extend(gl.sub(gl.mul(swap, gl.sub(ins[4:8], ins[0:4])), deltas))
        state = torch.cat([gl.add(ins[0:4], deltas), gl.sub(ins[4:8], deltas),
                           ins[8:]])

        state = full(gl.add(state, t["rc"][0]))
        for r in range(1, HALF_N_FULL_ROUNDS):
            sbox_in = wires_rows[self.wire_full_sbox_0(r, 0):
                                 self.wire_full_sbox_0(r, 0) + W]
            cons.extend(gl.sub(gl.add(state, t["rc"][r]), sbox_in))
            state = full(sbox_in)

        state = gl.add(state, t["first_rc"])
        rest = gl.reduce_sum(gl.mul(t["init"], state[1:].unsqueeze(1)), 0)
        head = state[0]
        m00 = MDS_MATRIX_CIRC[0] + MDS_MATRIX_DIAG[0]
        for r in range(N_PARTIAL_ROUNDS):
            sbox_in = wires_rows[self.wire_partial_sbox(r)]
            cons.append(gl.sub(head, sbox_in))
            s0 = gl.add(ps._sbox(sbox_in), t["partial_rc"][r])
            head = gl.add(gl.mul_small(s0, m00),
                          gl.reduce_sum(gl.mul(rest, t["w_hats"][r]), 0))
            rest = gl.add(rest, gl.mul(s0, t["vs"][r]))
        state = torch.cat([head.unsqueeze(0), rest])

        for r in range(HALF_N_FULL_ROUNDS):
            rnd = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS + r
            sbox_in = wires_rows[self.wire_full_sbox_1(r, 0):
                                 self.wire_full_sbox_1(r, 0) + W]
            cons.extend(gl.sub(gl.add(state, t["rc"][rnd]), sbox_in))
            state = full(sbox_in)

        cons.extend(gl.sub(state, wires_rows[W:2 * W]))
        return torch.stack(cons)

    def generators(self, row, local_constants):
        return [PoseidonGenerator(row)]


# generated wire columns in the reference's emission order
_TRACE_COLS = (
    list(range(PoseidonGate.START_DELTA, PoseidonGate.START_DELTA + 4))
    + list(range(PoseidonGate.START_FULL_0, PoseidonGate.START_FULL_0
                 + (HALF_N_FULL_ROUNDS - 1) * W))
    + list(range(PoseidonGate.START_PARTIAL,
                 PoseidonGate.START_PARTIAL + N_PARTIAL_ROUNDS))
    + list(range(PoseidonGate.START_FULL_1, PoseidonGate.START_FULL_1
                 + HALF_N_FULL_ROUNDS * W))
    + [PoseidonGate.wire_output(i) for i in range(W)]
)


class PoseidonGenerator(SimpleGenerator):
    def __init__(self, row):
        self.row = row

    def dependencies(self):
        g = PoseidonGate
        return ([wire(self.row, g.wire_input(i)) for i in range(W)]
                + [wire(self.row, g.WIRE_SWAP)])

    def run_once(self, witness, out):
        g = PoseidonGate
        row = self.row
        inputs = [witness.get(wire(row, g.wire_input(i))) for i in range(W)]
        swap = witness.get(wire(row, g.WIRE_SWAP))
        assert swap in (0, 1)
        trace = host.poseidon_generator_trace(inputs, swap)
        if trace is None:
            trace = _trace_python(inputs, swap)
        out.extend((wire(row, c), trace[c]) for c in _TRACE_COLS)

    def tape_op(self):
        return (tape.POSEIDON, self.dependencies(), (),
                [wire(self.row, c) for c in _TRACE_COLS])


def _trace_python(inputs, swap) -> dict:
    """The gate's wire row on python ints (column -> value), for hosts
    without a C compiler."""
    g, alg = PoseidonGate, pf.INT
    vals = {}
    state = list(inputs)
    for i in range(4):
        delta = swap * (inputs[i + 4] - inputs[i]) % ref.ORDER
        vals[g.wire_delta(i)] = delta
        state[i] = (inputs[i] + delta) % ref.ORDER
        state[i + 4] = (inputs[i + 4] - delta) % ref.ORDER
    round_ctr = 0
    for r in range(HALF_N_FULL_ROUNDS):
        state = pf.constant_layer(alg, state, round_ctr)
        if r != 0:
            for i in range(W):
                vals[g.wire_full_sbox_0(r, i)] = state[i]
        state = pf.mds_layer(alg, pf.sbox_layer(alg, state))
        round_ctr += 1
    partial_rc = pf.fast_partial_tables()[1]
    state = pf.mds_partial_layer_init(
        alg, pf.partial_first_constant_layer(alg, state))
    for r in range(N_PARTIAL_ROUNDS):
        vals[g.wire_partial_sbox(r)] = state[0]
        s0 = pf.sbox_monomial(alg, state[0])
        if r < N_PARTIAL_ROUNDS - 1:
            s0 = (s0 + partial_rc[r]) % ref.ORDER
        state = pf.mds_partial_layer_fast(alg, [s0] + state[1:], r)
    round_ctr += N_PARTIAL_ROUNDS
    for r in range(HALF_N_FULL_ROUNDS):
        state = pf.constant_layer(alg, state, round_ctr)
        for i in range(W):
            vals[g.wire_full_sbox_1(r, i)] = state[i]
        state = pf.mds_layer(alg, pf.sbox_layer(alg, state))
        round_ctr += 1
    for i in range(W):
        vals[g.wire_output(i)] = state[i]
    return vals
