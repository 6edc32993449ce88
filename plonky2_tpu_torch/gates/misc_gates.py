"""BaseSum, Exponentiation, RandomAccess, PoseidonMds gates.

Reference: plonky2/src/gates/base_sum.rs:29-280, exponentiation.rs:46-273,
random_access.rs:34-421, poseidon_mds.rs:36-265.
"""

from __future__ import annotations

from ..field import reference as ref
from ..hash.poseidon_constants import (
    MDS_MATRIX_CIRC, MDS_MATRIX_DIAG, SPONGE_WIDTH,
)
from ..iop import tape
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from .ext_algebra import ext_add, ext_scalar_mul_const, ext_sub
from .gate import Gate

D = 2


class BaseSumGate(Gate):
    """sum = sum_i limbs[i] * B^i with each limb range-checked in [0, B)."""

    WIRE_SUM = 0
    START_LIMBS = 1

    def __init__(self, num_limbs: int, base: int = 2):
        self.num_limbs = num_limbs
        self.base = base

    @staticmethod
    def new_from_config(config, base: int = 2) -> "BaseSumGate":
        # log_floor(ORDER - 1, base)
        num_limbs = 0
        acc = 1
        while acc * base <= ref.ORDER - 1:
            acc *= base
            num_limbs += 1
        num_limbs = min(num_limbs,
                        config.num_routed_wires - BaseSumGate.START_LIMBS)
        return BaseSumGate(num_limbs, base)

    def id(self):
        return f"BaseSumGate {{ num_limbs: {self.num_limbs} }} + Base: {self.base}"

    def limbs(self):
        return range(self.START_LIMBS, self.START_LIMBS + self.num_limbs)

    def num_wires(self):
        return 1 + self.num_limbs

    def degree(self):
        return self.base

    def num_constraints(self):
        return 1 + self.num_limbs

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        s = wires[self.WIRE_SUM]
        limbs = [wires[w] for w in self.limbs()]
        computed = alg.zero()
        for l in reversed(limbs):
            computed = alg.add(alg.mul_const(computed, self.base), l)
        out = [alg.sub(computed, s)]
        for l in limbs:
            acc = None
            for i in range(self.base):
                t = alg.add_const(l, (-i) % ref.ORDER)
                acc = t if acc is None else alg.mul(acc, t)
            out.append(acc)
        return out

    def generators(self, row, local_constants):
        return [BaseSplitGenerator(row, self.num_limbs, self.base)]


class BaseSplitGenerator(SimpleGenerator):
    def __init__(self, row, num_limbs, base):
        self.row, self.num_limbs, self.base = row, num_limbs, base

    def dependencies(self):
        return [wire(self.row, BaseSumGate.WIRE_SUM)]

    def run_once(self, witness, out):
        acc = witness.get(wire(self.row, BaseSumGate.WIRE_SUM))
        for i in range(self.num_limbs):
            out.append((wire(self.row, BaseSumGate.START_LIMBS + i),
                        acc % self.base))
            acc //= self.base
        assert acc == 0, "Integer too large to fit in given number of limbs"


class ExponentiationGate(Gate):
    """base^(bits, LE) by square-and-multiply, one intermediate per bit."""

    def __init__(self, num_power_bits: int):
        self.num_power_bits = num_power_bits

    @staticmethod
    def from_config(config) -> "ExponentiationGate":
        return ExponentiationGate(min(config.num_routed_wires - 2,
                                      (config.num_wires - 2) // 2))

    def id(self):
        return (f"ExponentiationGate {{ num_power_bits: {self.num_power_bits},"
                f" _phantom: PhantomData<plonky2_field::goldilocks_field::GoldilocksField> }}")

    def wire_base(self):
        return 0

    def wire_power_bit(self, i):
        return 1 + i

    def wire_output(self):
        return 1 + self.num_power_bits

    def wire_intermediate_value(self, i):
        return 2 + self.num_power_bits + i

    def num_wires(self):
        return self.wire_intermediate_value(self.num_power_bits - 1) + 1

    def degree(self):
        return 4

    def num_constraints(self):
        return self.num_power_bits + 1

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        base = wires[self.wire_base()]
        bits = [wires[self.wire_power_bit(i)]
                for i in range(self.num_power_bits)]
        inter = [wires[self.wire_intermediate_value(i)]
                 for i in range(self.num_power_bits)]
        output = wires[self.wire_output()]
        one = alg.const(1)
        out = []
        for i in range(self.num_power_bits):
            prev = one if i == 0 else alg.mul(inter[i - 1], inter[i - 1])
            cur_bit = bits[self.num_power_bits - i - 1]
            not_bit = alg.sub(one, cur_bit)
            computed = alg.mul(prev, alg.add(alg.mul(cur_bit, base), not_bit))
            out.append(alg.sub(computed, inter[i]))
        out.append(alg.sub(output, inter[-1]))
        return out

    def generators(self, row, local_constants):
        return [_ExponentiationGenerator(row, self)]


class _ExponentiationGenerator(SimpleGenerator):
    def __init__(self, row, gate: ExponentiationGate):
        self.row, self.gate = row, gate

    def dependencies(self):
        g = self.gate
        return ([wire(self.row, g.wire_base())]
                + [wire(self.row, g.wire_power_bit(i))
                   for i in range(g.num_power_bits)])

    def run_once(self, witness, out):
        g = self.gate
        base = witness.get(wire(self.row, g.wire_base()))
        bits = [witness.get(wire(self.row, g.wire_power_bit(i)))
                for i in range(g.num_power_bits)]
        inter = 1
        for i in range(g.num_power_bits):
            prev = 1 if i == 0 else (inter * inter) % ref.ORDER
            cur_bit = bits[g.num_power_bits - i - 1]
            inter = prev * (cur_bit * base + (1 - cur_bit)) % ref.ORDER
            out.append((wire(self.row, g.wire_intermediate_value(i)), inter))
        out.append((wire(self.row, g.wire_output()), inter))


class RandomAccessGate(Gate):
    """claimed == list[access_index] by a binary selection tree; multiple
    copies per row; leftover routed wires host build-time constants."""

    def __init__(self, bits: int, num_copies: int, num_extra_constants: int):
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants

    @staticmethod
    def from_config(config, bits: int) -> "RandomAccessGate":
        vec_size = 1 << bits
        max_copies = min(config.num_routed_wires // (2 + vec_size),
                         config.num_wires // (2 + vec_size + bits))
        max_extra = config.num_routed_wires - (2 + vec_size) * max_copies
        return RandomAccessGate(bits, max_copies,
                                min(max_extra, config.num_constants))

    def id(self):
        return (f"RandomAccessGate {{ bits: {self.bits}, num_copies: "
                f"{self.num_copies}, num_extra_constants: "
                f"{self.num_extra_constants}, _phantom: PhantomData<plonky2_field::goldilocks_field::GoldilocksField> }}")

    def vec_size(self):
        return 1 << self.bits

    def wire_access_index(self, copy):
        return (2 + self.vec_size()) * copy

    def wire_claimed_element(self, copy):
        return (2 + self.vec_size()) * copy + 1

    def wire_list_item(self, i, copy):
        return (2 + self.vec_size()) * copy + 2 + i

    def _start_extra_constants(self):
        return (2 + self.vec_size()) * self.num_copies

    def wire_extra_constant(self, i):
        return self._start_extra_constants() + i

    def num_routed_wires(self):
        return self._start_extra_constants() + self.num_extra_constants

    def wire_bit(self, i, copy):
        return self.num_routed_wires() + copy * self.bits + i

    def num_wires(self):
        return self.wire_bit(self.bits - 1, self.num_copies - 1) + 1

    def num_constants(self):
        return self.num_extra_constants

    def degree(self):
        return self.bits + 1

    def num_constraints(self):
        return self.num_copies * (self.bits + 2) + self.num_extra_constants

    def num_ops(self):
        return self.num_copies

    def extra_constant_wires(self):
        return [(i, self.wire_extra_constant(i))
                for i in range(self.num_extra_constants)]

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        one = alg.const(1)
        out = []
        for copy in range(self.num_copies):
            access_index = wires[self.wire_access_index(copy)]
            items = [wires[self.wire_list_item(i, copy)]
                     for i in range(self.vec_size())]
            claimed = wires[self.wire_claimed_element(copy)]
            bits = [wires[self.wire_bit(i, copy)] for i in range(self.bits)]
            for b in bits:
                out.append(alg.mul(b, alg.sub(b, one)))
            recon = alg.zero()
            for b in reversed(bits):
                recon = alg.add(alg.add(recon, recon), b)
            out.append(alg.sub(recon, access_index))
            for b in bits:
                items = [alg.add(items[2 * k],
                                 alg.mul(b, alg.sub(items[2 * k + 1],
                                                    items[2 * k])))
                         for k in range(len(items) // 2)]
            out.append(alg.sub(items[0], claimed))
        for i in range(self.num_extra_constants):
            out.append(alg.sub(consts[i], wires[self.wire_extra_constant(i)]))
        return out

    def generators(self, row, local_constants):
        return [_RandomAccessGenerator(row, self, c)
                for c in range(self.num_copies)]


class _RandomAccessGenerator(SimpleGenerator):
    def __init__(self, row, gate: RandomAccessGate, copy: int):
        self.row, self.gate, self.copy = row, gate, copy

    def dependencies(self):
        g, c = self.gate, self.copy
        return ([wire(self.row, g.wire_access_index(c))]
                + [wire(self.row, g.wire_list_item(i, c))
                   for i in range(g.vec_size())])

    def run_once(self, witness, out):
        g, c = self.gate, self.copy
        idx = witness.get(wire(self.row, g.wire_access_index(c)))
        assert idx < g.vec_size(), \
            f"Access index {idx} >= vector size {g.vec_size()}"
        out.append((wire(self.row, g.wire_claimed_element(c)),
                    witness.get(wire(self.row, g.wire_list_item(idx, c)))))
        for i in range(g.bits):
            out.append((wire(self.row, g.wire_bit(i, c)), (idx >> i) & 1))

    def tape_op(self):
        g, c = self.gate, self.copy
        return (tape.RANDOM_ACCESS, self.dependencies(), (),
                [wire(self.row, g.wire_claimed_element(c))]
                + [wire(self.row, g.wire_bit(i, c)) for i in range(g.bits)])


class PoseidonMdsGate(Gate):
    """One MDS layer over 12 extension inputs (reference: poseidon_mds.rs)."""

    def id(self):
        return "PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH=12>"

    @staticmethod
    def wires_input(i):
        return range(i * D, (i + 1) * D)

    @staticmethod
    def wires_output(i):
        return range((SPONGE_WIDTH + i) * D, (SPONGE_WIDTH + i + 1) * D)

    def num_wires(self):
        return 2 * D * SPONGE_WIDTH

    def degree(self):
        return 1

    def num_constraints(self):
        return SPONGE_WIDTH * D

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        ins = [tuple(wires[w] for w in self.wires_input(i))
               for i in range(SPONGE_WIDTH)]
        out = []
        for r in range(SPONGE_WIDTH):
            acc = ext_scalar_mul_const(alg, ins[r], MDS_MATRIX_DIAG[r]) \
                if MDS_MATRIX_DIAG[r] else None
            for i in range(SPONGE_WIDTH):
                term = ext_scalar_mul_const(alg, ins[(i + r) % SPONGE_WIDTH],
                                            MDS_MATRIX_CIRC[i])
                acc = term if acc is None else ext_add(alg, acc, term)
            output = tuple(wires[w] for w in self.wires_output(r))
            out.extend(ext_sub(alg, acc, output))
        return out

    def generators(self, row, local_constants):
        return [_PoseidonMdsGenerator(row)]


class _PoseidonMdsGenerator(SimpleGenerator):
    def __init__(self, row):
        self.row = row

    def dependencies(self):
        return [wire(self.row, w) for i in range(SPONGE_WIDTH)
                for w in PoseidonMdsGate.wires_input(i)]

    def run_once(self, witness, out):
        g = PoseidonMdsGate
        ins = [tuple(witness.get(wire(self.row, w)) for w in g.wires_input(i))
               for i in range(SPONGE_WIDTH)]
        for r in range(SPONGE_WIDTH):
            acc = (0, 0)
            for i in range(SPONGE_WIDTH):
                acc = ref.ext2_add(acc, ref.ext2_scalar_mul(
                    ins[(i + r) % SPONGE_WIDTH], MDS_MATRIX_CIRC[i]))
            acc = ref.ext2_add(acc, ref.ext2_scalar_mul(ins[r],
                                                        MDS_MATRIX_DIAG[r]))
            for w, v in zip(g.wires_output(r), acc):
                out.append((wire(self.row, w), v))
