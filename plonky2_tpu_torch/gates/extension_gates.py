"""Extension-field arithmetic gates: ArithmeticExtension, MulExtension,
Reducing, ReducingExtension.

Reference: plonky2/src/gates/arithmetic_extension.rs:27-55 (4D wires/op),
multiplication_extension.rs:27-52 (3D wires/op), reducing.rs:25-61,
reducing_extension.rs:25-64. D=2 throughout (the proving extension).
"""

from __future__ import annotations

from ..field import reference as ref
from ..iop import tape
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from .ext_algebra import ext_add, ext_mul, ext_scalar_mul, ext_sub
from .gate import Gate

D = 2


class ArithmeticExtensionGate(Gate):
    """out_i = c0 * m0_i * m1_i + c1 * addend_i over F_{p^2} wire pairs."""

    def __init__(self, num_ops: int):
        self._num_ops = num_ops

    @staticmethod
    def from_config(config):
        return ArithmeticExtensionGate(config.num_routed_wires // (4 * D))

    def id(self):
        return f"ArithmeticExtensionGate {{ num_ops: {self._num_ops} }}"

    @staticmethod
    def wires_multiplicand_0(i):
        return range(4 * D * i, 4 * D * i + D)

    @staticmethod
    def wires_multiplicand_1(i):
        return range(4 * D * i + D, 4 * D * i + 2 * D)

    @staticmethod
    def wires_addend(i):
        return range(4 * D * i + 2 * D, 4 * D * i + 3 * D)

    @staticmethod
    def wires_output(i):
        return range(4 * D * i + 3 * D, 4 * D * i + 4 * D)

    def num_wires(self):
        return 4 * D * self._num_ops

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return D * self._num_ops

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        c0, c1 = consts[0], consts[1]
        out = []
        for i in range(self._num_ops):
            m0 = tuple(wires[w] for w in self.wires_multiplicand_0(i))
            m1 = tuple(wires[w] for w in self.wires_multiplicand_1(i))
            addend = tuple(wires[w] for w in self.wires_addend(i))
            output = tuple(wires[w] for w in self.wires_output(i))
            computed = ext_add(alg, ext_scalar_mul(alg, ext_mul(alg, m0, m1),
                                                   c0),
                               ext_scalar_mul(alg, addend, c1))
            out.extend(ext_sub(alg, output, computed))
        return out

    def generators(self, row, local_constants):
        c0, c1 = int(local_constants[0]), int(local_constants[1])
        return [_ArithmeticExtOpGenerator(row, i, c0, c1)
                for i in range(self._num_ops)]


class _ArithmeticExtOpGenerator(SimpleGenerator):
    def __init__(self, row, i, c0, c1):
        self.row, self.i, self.c0, self.c1 = row, i, c0, c1

    def dependencies(self):
        g = ArithmeticExtensionGate
        return [wire(self.row, w) for rng in
                (g.wires_multiplicand_0(self.i), g.wires_multiplicand_1(self.i),
                 g.wires_addend(self.i)) for w in rng]

    def run_once(self, witness, out):
        g = ArithmeticExtensionGate
        get = lambda rng: tuple(witness.get(wire(self.row, w)) for w in rng)
        m0 = get(g.wires_multiplicand_0(self.i))
        m1 = get(g.wires_multiplicand_1(self.i))
        addend = get(g.wires_addend(self.i))
        val = ref.ext2_add(ref.ext2_scalar_mul(ref.ext2_mul(m0, m1), self.c0),
                           ref.ext2_scalar_mul(addend, self.c1))
        for w, v in zip(g.wires_output(self.i), val):
            out.append((wire(self.row, w), v))

    def tape_op(self):
        return (tape.ARITHMETIC_EXT, self.dependencies(), (self.c0, self.c1),
                [wire(self.row, w)
                 for w in ArithmeticExtensionGate.wires_output(self.i)])


class MulExtensionGate(Gate):
    """out_i = c0 * m0_i * m1_i over F_{p^2} wire pairs."""

    def __init__(self, num_ops: int):
        self._num_ops = num_ops

    @staticmethod
    def from_config(config):
        return MulExtensionGate(config.num_routed_wires // (3 * D))

    def id(self):
        return f"MulExtensionGate {{ num_ops: {self._num_ops} }}"

    @staticmethod
    def wires_multiplicand_0(i):
        return range(3 * D * i, 3 * D * i + D)

    @staticmethod
    def wires_multiplicand_1(i):
        return range(3 * D * i + D, 3 * D * i + 2 * D)

    @staticmethod
    def wires_output(i):
        return range(3 * D * i + 2 * D, 3 * D * i + 3 * D)

    def num_wires(self):
        return 3 * D * self._num_ops

    def num_constants(self):
        return 1

    def degree(self):
        return 3

    def num_constraints(self):
        return D * self._num_ops

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        c0 = consts[0]
        out = []
        for i in range(self._num_ops):
            m0 = tuple(wires[w] for w in self.wires_multiplicand_0(i))
            m1 = tuple(wires[w] for w in self.wires_multiplicand_1(i))
            output = tuple(wires[w] for w in self.wires_output(i))
            computed = ext_scalar_mul(alg, ext_mul(alg, m0, m1), c0)
            out.extend(ext_sub(alg, output, computed))
        return out

    def generators(self, row, local_constants):
        return [_MulExtOpGenerator(row, i, int(local_constants[0]))
                for i in range(self._num_ops)]


class _MulExtOpGenerator(SimpleGenerator):
    def __init__(self, row, i, c0):
        self.row, self.i, self.c0 = row, i, c0

    def dependencies(self):
        g = MulExtensionGate
        return [wire(self.row, w) for rng in
                (g.wires_multiplicand_0(self.i), g.wires_multiplicand_1(self.i))
                for w in rng]

    def run_once(self, witness, out):
        g = MulExtensionGate
        get = lambda rng: tuple(witness.get(wire(self.row, w)) for w in rng)
        val = ref.ext2_scalar_mul(
            ref.ext2_mul(get(g.wires_multiplicand_0(self.i)),
                         get(g.wires_multiplicand_1(self.i))), self.c0)
        for w, v in zip(g.wires_output(self.i), val):
            out.append((wire(self.row, w), v))

    def tape_op(self):
        return (tape.MUL_EXT, self.dependencies(), (self.c0,),
                [wire(self.row, w)
                 for w in MulExtensionGate.wires_output(self.i)])


class ReducingExtensionGate(Gate):
    """acc_i = acc_{i-1} * alpha + coeff_i over extension coefficients
    (reference: reducing_extension.rs)."""

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires):
        return min((num_routed_wires - 3 * D) // D,
                   (num_wires - 2 * D) // (2 * D))

    def id(self):
        return f"ReducingExtensionGate {{ num_coeffs: {self.num_coeffs} }}"

    @staticmethod
    def wires_output():
        return range(0, D)

    @staticmethod
    def wires_alpha():
        return range(D, 2 * D)

    @staticmethod
    def wires_old_acc():
        return range(2 * D, 3 * D)

    @staticmethod
    def wires_coeff(i):
        return range(3 * D + i * D, 3 * D + (i + 1) * D)

    def _start_accs(self):
        return 3 * D + self.num_coeffs * D

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        s = self._start_accs() + D * i
        return range(s, s + D)

    def num_wires(self):
        return self._start_accs() + D * (self.num_coeffs - 1)

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.num_coeffs

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        get = lambda rng: tuple(wires[w] for w in rng)
        alpha = get(self.wires_alpha())
        acc = get(self.wires_old_acc())
        out = []
        for i in range(self.num_coeffs):
            coeff = get(self.wires_coeff(i))
            acc_next = get(self.wires_accs(i))
            computed = ext_add(alg, ext_mul(alg, acc, alpha), coeff)
            out.extend(ext_sub(alg, computed, acc_next))
            acc = acc_next
        return out

    def generators(self, row, local_constants):
        return [_ReducingExtGenerator(row, self)]


class _ReducingExtGenerator(SimpleGenerator):
    def __init__(self, row, gate: ReducingExtensionGate):
        self.row, self.gate = row, gate

    def dependencies(self):
        g = self.gate
        deps = [wire(self.row, w) for w in g.wires_alpha()]
        deps += [wire(self.row, w) for w in g.wires_old_acc()]
        for i in range(g.num_coeffs):
            deps += [wire(self.row, w) for w in g.wires_coeff(i)]
        return deps

    def run_once(self, witness, out):
        g = self.gate
        get = lambda rng: tuple(witness.get(wire(self.row, w)) for w in rng)
        alpha = get(g.wires_alpha())
        acc = get(g.wires_old_acc())
        for i in range(g.num_coeffs):
            acc = ref.ext2_add(ref.ext2_mul(acc, alpha), get(g.wires_coeff(i)))
            for w, v in zip(g.wires_accs(i), acc):
                out.append((wire(self.row, w), v))

    def tape_op(self):
        return (tape.REDUCING_EXT, self.dependencies(), (),
                _accs(self.row, self.gate))


class ReducingGate(Gate):
    """Like ReducingExtensionGate but coefficients are base-field wires
    (reference: reducing.rs)."""

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires):
        return min(num_routed_wires - 3 * D, (num_wires - 2 * D) // (D + 1))

    def id(self):
        return f"ReducingGate {{ num_coeffs: {self.num_coeffs} }}"

    @staticmethod
    def wires_output():
        return range(0, D)

    @staticmethod
    def wires_alpha():
        return range(D, 2 * D)

    @staticmethod
    def wires_old_acc():
        return range(2 * D, 3 * D)

    def wires_coeffs(self):
        return range(3 * D, 3 * D + self.num_coeffs)

    def _start_accs(self):
        return 3 * D + self.num_coeffs

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        s = self._start_accs() + D * i
        return range(s, s + D)

    def num_wires(self):
        return self._start_accs() + D * (self.num_coeffs - 1)

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.num_coeffs

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        get = lambda rng: tuple(wires[w] for w in rng)
        alpha = get(self.wires_alpha())
        acc = get(self.wires_old_acc())
        coeffs = [wires[w] for w in self.wires_coeffs()]
        out = []
        for i in range(self.num_coeffs):
            acc_next = get(self.wires_accs(i))
            computed = ext_add(alg, ext_mul(alg, acc, alpha),
                               (coeffs[i], alg.zero()))
            out.extend(ext_sub(alg, computed, acc_next))
            acc = acc_next
        return out

    def generators(self, row, local_constants):
        return [_ReducingGenerator(row, self)]


class _ReducingGenerator(SimpleGenerator):
    def __init__(self, row, gate: ReducingGate):
        self.row, self.gate = row, gate

    def dependencies(self):
        g = self.gate
        deps = [wire(self.row, w) for w in g.wires_alpha()]
        deps += [wire(self.row, w) for w in g.wires_old_acc()]
        deps += [wire(self.row, w) for w in g.wires_coeffs()]
        return deps

    def run_once(self, witness, out):
        g = self.gate
        get = lambda rng: tuple(witness.get(wire(self.row, w)) for w in rng)
        alpha = get(g.wires_alpha())
        acc = get(g.wires_old_acc())
        for i, w_c in enumerate(g.wires_coeffs()):
            c = witness.get(wire(self.row, w_c))
            acc = ref.ext2_add(ref.ext2_mul(acc, alpha), (c, 0))
            for w, v in zip(g.wires_accs(i), acc):
                out.append((wire(self.row, w), v))

    def tape_op(self):
        return (tape.REDUCING, self.dependencies(), (),
                _accs(self.row, self.gate))


def _accs(row, gate) -> list:
    """The accumulator targets a Reducing(Extension) generator writes, in
    its order."""
    return [wire(row, w) for i in range(gate.num_coeffs)
            for w in gate.wires_accs(i)]
