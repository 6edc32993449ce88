"""Arithmetic / Constant / PublicInput / Noop gates
(reference arithmetic_base.rs:29,
constant.rs:25, public_input.rs, noop.rs)."""

from __future__ import annotations

from ..field import goldilocks as gl
from ..field import reference as ref
from ..iop import tape
from ..iop.generator import ConstantGenerator, SimpleGenerator
from ..iop.target import wire
from .gate import Gate


class ArithmeticGate(Gate):
    """Batched weighted multiply-add: out_i = c0 * x_i * y_i + c1 * z_i."""

    def __init__(self, num_ops: int):
        self._num_ops = num_ops

    @staticmethod
    def from_config(config) -> "ArithmeticGate":
        return ArithmeticGate(config.num_routed_wires // 4)

    def id(self):
        return f"ArithmeticGate {{ num_ops: {self._num_ops} }}"

    @staticmethod
    def wire_multiplicand_0(i):
        return 4 * i

    @staticmethod
    def wire_multiplicand_1(i):
        return 4 * i + 1

    @staticmethod
    def wire_addend(i):
        return 4 * i + 2

    @staticmethod
    def wire_output(i):
        return 4 * i + 3

    def num_wires(self):
        return 4 * self._num_ops

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return self._num_ops

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        c0, c1 = consts[0], consts[1]
        out = []
        for i in range(self._num_ops):
            m0 = wires[self.wire_multiplicand_0(i)]
            m1 = wires[self.wire_multiplicand_1(i)]
            addend = wires[self.wire_addend(i)]
            output = wires[self.wire_output(i)]
            computed = alg.add(alg.mul(alg.mul(m0, m1), c0),
                               alg.mul(addend, c1))
            out.append(alg.sub(output, computed))
        return out

    def eval_unfiltered_rows(self, consts_rows, wires_rows, pi_rows):
        k, N = self._num_ops, wires_rows.shape[-1]
        ops = wires_rows[:4 * k].reshape(k, 4, N)
        computed = gl.add(
            gl.mul(gl.mul(ops[:, 0], ops[:, 1]), consts_rows[0]),
            gl.mul(ops[:, 2], consts_rows[1]))
        return gl.sub(ops[:, 3], computed)

    def generators(self, row, local_constants):
        c0, c1 = int(local_constants[0]), int(local_constants[1])
        return [_ArithmeticOpGenerator(row, i, c0, c1)
                for i in range(self._num_ops)]


class _ArithmeticOpGenerator(SimpleGenerator):
    def __init__(self, row, i, c0, c1):
        self.row, self.i, self.c0, self.c1 = row, i, c0, c1

    def dependencies(self):
        g = ArithmeticGate
        return [wire(self.row, g.wire_multiplicand_0(self.i)),
                wire(self.row, g.wire_multiplicand_1(self.i)),
                wire(self.row, g.wire_addend(self.i))]

    def run_once(self, witness, out):
        m0, m1, z = (witness.get(t) for t in self.dependencies())
        val = (self.c0 * m0 % ref.ORDER * m1 + self.c1 * z) % ref.ORDER
        out.append((wire(self.row, ArithmeticGate.wire_output(self.i)), val))

    def tape_op(self):
        return (tape.ARITHMETIC, self.dependencies(), (self.c0, self.c1),
                [wire(self.row, ArithmeticGate.wire_output(self.i))])


class ConstantGate(Gate):
    """Routes build-time constants to wires: constants[i] - wires[i]."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def id(self):
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def num_wires(self):
        return self.num_consts

    def num_constants(self):
        return self.num_consts

    def degree(self):
        return 1

    def num_constraints(self):
        return self.num_consts

    def extra_constant_wires(self):
        return [(i, i) for i in range(self.num_consts)]

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        return [alg.sub(consts[i], wires[i]) for i in range(self.num_consts)]

    def generators(self, row, local_constants):
        return [ConstantGenerator(row, i, i, int(local_constants[i]))
                for i in range(self.num_consts)]


class PublicInputGate(Gate):
    """Ties wires 0..4 to the public-input hash."""

    def id(self):
        return "PublicInputGate"

    @staticmethod
    def wires_public_inputs_hash():
        return range(4)

    def num_wires(self):
        return 4

    def degree(self):
        return 1

    def num_constraints(self):
        return 4

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        return [alg.sub(wires[i], pi_hash[i]) for i in range(4)]


class NoopGate(Gate):
    def id(self):
        return "NoopGate"

    def num_wires(self):
        return 0

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        return []
