"""u32 arithmetic gates + gadgets (the `u32` gadget crate).

Reference: u32/src/gates/arithmetic_u32.rs:44-290 (x*y+z -> (lo32, hi32) with
base-4 limb range checks + canonical-encoding check), add_many_u32.rs:45-290,
subtraction_u32.rs:50-280; u32/src/gadgets/arithmetic_u32.rs (U32Target,
CircuitBuilderU32).
"""

from __future__ import annotations

from ..field import reference as ref
from ..gates.gate import Gate
from ..iop.generator import SimpleGenerator
from ..iop.target import wire

U32_MAX = (1 << 32) - 1


class U32ArithmeticGate(Gate):
    """out = x*y + z decomposed into 32-bit halves with range checks."""

    LIMB_BITS = 2
    NUM_LIMBS = 64 // LIMB_BITS
    ROUTED_PER_OP = 6

    def __init__(self, num_ops: int):
        self._num_ops = num_ops

    @staticmethod
    def from_config(config):
        per_op = U32ArithmeticGate.ROUTED_PER_OP + U32ArithmeticGate.NUM_LIMBS
        return U32ArithmeticGate(min(
            config.num_wires // per_op,
            config.num_routed_wires // U32ArithmeticGate.ROUTED_PER_OP))

    def id(self):
        return f"U32ArithmeticGate {{ num_ops: {self._num_ops} }}"

    def wire_multiplicand_0(self, i):
        return self.ROUTED_PER_OP * i

    def wire_multiplicand_1(self, i):
        return self.ROUTED_PER_OP * i + 1

    def wire_addend(self, i):
        return self.ROUTED_PER_OP * i + 2

    def wire_output_low(self, i):
        return self.ROUTED_PER_OP * i + 3

    def wire_output_high(self, i):
        return self.ROUTED_PER_OP * i + 4

    def wire_inverse(self, i):
        return self.ROUTED_PER_OP * i + 5

    def wire_limb(self, i, j):
        return self.ROUTED_PER_OP * self._num_ops + self.NUM_LIMBS * i + j

    def num_wires(self):
        return self._num_ops * (self.ROUTED_PER_OP + self.NUM_LIMBS)

    def degree(self):
        return 1 << self.LIMB_BITS

    def num_constraints(self):
        return self._num_ops * (4 + self.NUM_LIMBS)

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        out = []
        one = alg.const(1)
        for i in range(self._num_ops):
            m0 = wires[self.wire_multiplicand_0(i)]
            m1 = wires[self.wire_multiplicand_1(i)]
            z = wires[self.wire_addend(i)]
            computed = alg.add(alg.mul(m0, m1), z)
            lo = wires[self.wire_output_low(i)]
            hi = wires[self.wire_output_high(i)]
            inv = wires[self.wire_inverse(i)]
            # canonicity: hi==u32::MAX forces lo==0
            diff = alg.sub(alg.const(U32_MAX), hi)
            hi_not_max = alg.sub(alg.mul(inv, diff), one)
            out.append(alg.mul(hi_not_max, lo))
            combined = alg.add(alg.mul_const(hi, 1 << 32), lo)
            out.append(alg.sub(combined, computed))
            # limb range checks + recomposition
            comb_lo = alg.zero()
            comb_hi = alg.zero()
            mid = self.NUM_LIMBS // 2
            for j in reversed(range(self.NUM_LIMBS)):
                limb = wires[self.wire_limb(i, j)]
                prod = None
                for x in range(1 << self.LIMB_BITS):
                    t = alg.add_const(limb, (-x) % ref.ORDER)
                    prod = t if prod is None else alg.mul(prod, t)
                out.append(prod)
                if j < mid:
                    comb_lo = alg.add(alg.mul_const(comb_lo,
                                                    1 << self.LIMB_BITS), limb)
                else:
                    comb_hi = alg.add(alg.mul_const(comb_hi,
                                                    1 << self.LIMB_BITS), limb)
            out.append(alg.sub(comb_lo, lo))
            out.append(alg.sub(comb_hi, hi))
        return out

    def generators(self, row, local_constants):
        return [_U32ArithmeticGenerator(row, self, i)
                for i in range(self._num_ops)]


class _U32ArithmeticGenerator(SimpleGenerator):
    def __init__(self, row, gate, i):
        self.row, self.gate, self.i = row, gate, i

    def dependencies(self):
        g, i = self.gate, self.i
        return [wire(self.row, g.wire_multiplicand_0(i)),
                wire(self.row, g.wire_multiplicand_1(i)),
                wire(self.row, g.wire_addend(i))]

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        m0 = witness.get(wire(self.row, g.wire_multiplicand_0(i)))
        m1 = witness.get(wire(self.row, g.wire_multiplicand_1(i)))
        z = witness.get(wire(self.row, g.wire_addend(i)))
        val = (m0 * m1 + z) % ref.ORDER
        lo, hi = val & U32_MAX, val >> 32
        out.append((wire(self.row, g.wire_output_low(i)), lo))
        out.append((wire(self.row, g.wire_output_high(i)), hi))
        diff = U32_MAX - hi
        out.append((wire(self.row, g.wire_inverse(i)),
                    ref.inverse(diff) if diff else 0))
        v = val
        for j in range(g.NUM_LIMBS):
            out.append((wire(self.row, g.wire_limb(i, j)),
                        v % (1 << g.LIMB_BITS)))
            v >>= g.LIMB_BITS


class U32AddManyGate(Gate):
    """sum of num_addends u32s + small carry -> (result u32, carry)."""

    LIMB_BITS = 2
    LOG2_MAX_NUM_ADDENDS = 4
    RESULT_LIMBS = 32 // LIMB_BITS
    CARRY_LIMBS = LOG2_MAX_NUM_ADDENDS // LIMB_BITS

    def __init__(self, num_addends: int, num_ops: int):
        self.num_addends = num_addends
        self._num_ops = num_ops

    @staticmethod
    def from_config(config, num_addends: int):
        assert num_addends <= 16
        nl = U32AddManyGate.RESULT_LIMBS + U32AddManyGate.CARRY_LIMBS
        per_op = num_addends + 3 + nl
        routed = num_addends + 3
        return U32AddManyGate(num_addends, min(
            config.num_wires // per_op, config.num_routed_wires // routed))

    def id(self):
        return (f"U32AddManyGate {{ num_addends: {self.num_addends}, "
                f"num_ops: {self._num_ops} }}")

    def _stride(self):
        return self.num_addends + 3

    def wire_addend(self, i, j):
        return self._stride() * i + j

    def wire_carry(self, i):
        return self._stride() * i + self.num_addends

    def wire_output_result(self, i):
        return self._stride() * i + self.num_addends + 1

    def wire_output_carry(self, i):
        return self._stride() * i + self.num_addends + 2

    def _num_limbs(self):
        return self.RESULT_LIMBS + self.CARRY_LIMBS

    def wire_limb(self, i, j):
        return self._stride() * self._num_ops + self._num_limbs() * i + j

    def num_wires(self):
        return (self._stride() + self._num_limbs()) * self._num_ops

    def degree(self):
        return 1 << self.LIMB_BITS

    def num_constraints(self):
        return self._num_ops * (3 + self._num_limbs())

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        out = []
        for i in range(self._num_ops):
            computed = wires[self.wire_carry(i)]
            for j in range(self.num_addends):
                computed = alg.add(computed, wires[self.wire_addend(i, j)])
            result = wires[self.wire_output_result(i)]
            carry = wires[self.wire_output_carry(i)]
            combined = alg.add(alg.mul_const(carry, 1 << 32), result)
            out.append(alg.sub(combined, computed))
            comb_res = alg.zero()
            comb_car = alg.zero()
            for j in reversed(range(self._num_limbs())):
                limb = wires[self.wire_limb(i, j)]
                prod = None
                for x in range(1 << self.LIMB_BITS):
                    t = alg.add_const(limb, (-x) % ref.ORDER)
                    prod = t if prod is None else alg.mul(prod, t)
                out.append(prod)
                if j < self.RESULT_LIMBS:
                    comb_res = alg.add(
                        alg.mul_const(comb_res, 1 << self.LIMB_BITS), limb)
                else:
                    comb_car = alg.add(
                        alg.mul_const(comb_car, 1 << self.LIMB_BITS), limb)
            out.append(alg.sub(comb_res, result))
            out.append(alg.sub(comb_car, carry))
        return out

    def generators(self, row, local_constants):
        return [_U32AddManyGenerator(row, self, i)
                for i in range(self._num_ops)]


class _U32AddManyGenerator(SimpleGenerator):
    def __init__(self, row, gate, i):
        self.row, self.gate, self.i = row, gate, i

    def dependencies(self):
        g, i = self.gate, self.i
        return ([wire(self.row, g.wire_addend(i, j))
                 for j in range(g.num_addends)]
                + [wire(self.row, g.wire_carry(i))])

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        total = witness.get(wire(self.row, g.wire_carry(i)))
        for j in range(g.num_addends):
            total += witness.get(wire(self.row, g.wire_addend(i, j)))
        result, carry = total & U32_MAX, total >> 32
        out.append((wire(self.row, g.wire_output_result(i)), result))
        out.append((wire(self.row, g.wire_output_carry(i)), carry))
        v = result | (carry << 32)
        for j in range(g._num_limbs()):
            out.append((wire(self.row, g.wire_limb(i, j)),
                        v % (1 << g.LIMB_BITS)))
            v >>= g.LIMB_BITS


class U32SubtractionGate(Gate):
    """x - y - borrow_in -> (result u32, borrow_out bit)."""

    LIMB_BITS = 2
    NUM_LIMBS = 32 // LIMB_BITS

    def __init__(self, num_ops: int):
        self._num_ops = num_ops

    @staticmethod
    def from_config(config):
        per_op = 5 + U32SubtractionGate.NUM_LIMBS
        return U32SubtractionGate(min(config.num_wires // per_op,
                                      config.num_routed_wires // 5))

    def id(self):
        return f"U32SubtractionGate {{ num_ops: {self._num_ops} }}"

    def wire_input_x(self, i):
        return 5 * i

    def wire_input_y(self, i):
        return 5 * i + 1

    def wire_input_borrow(self, i):
        return 5 * i + 2

    def wire_output_result(self, i):
        return 5 * i + 3

    def wire_output_borrow(self, i):
        return 5 * i + 4

    def wire_limb(self, i, j):
        return 5 * self._num_ops + self.NUM_LIMBS * i + j

    def num_wires(self):
        return (5 + self.NUM_LIMBS) * self._num_ops

    def degree(self):
        return 1 << self.LIMB_BITS

    def num_constraints(self):
        return self._num_ops * (3 + self.NUM_LIMBS)

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        out = []
        one = alg.const(1)
        for i in range(self._num_ops):
            x = wires[self.wire_input_x(i)]
            y = wires[self.wire_input_y(i)]
            bin_ = wires[self.wire_input_borrow(i)]
            result = wires[self.wire_output_result(i)]
            bout = wires[self.wire_output_borrow(i)]
            initial = alg.sub(alg.sub(x, y), bin_)
            out.append(alg.sub(result,
                               alg.add(initial, alg.mul_const(bout, 1 << 32))))
            comb = alg.zero()
            for j in reversed(range(self.NUM_LIMBS)):
                limb = wires[self.wire_limb(i, j)]
                prod = None
                for v in range(1 << self.LIMB_BITS):
                    t = alg.add_const(limb, (-v) % ref.ORDER)
                    prod = t if prod is None else alg.mul(prod, t)
                out.append(prod)
                comb = alg.add(alg.mul_const(comb, 1 << self.LIMB_BITS), limb)
            out.append(alg.sub(comb, result))
            out.append(alg.mul(bout, alg.sub(one, bout)))
        return out

    def generators(self, row, local_constants):
        return [_U32SubtractionGenerator(row, self, i)
                for i in range(self._num_ops)]


class _U32SubtractionGenerator(SimpleGenerator):
    def __init__(self, row, gate, i):
        self.row, self.gate, self.i = row, gate, i

    def dependencies(self):
        g, i = self.gate, self.i
        return [wire(self.row, g.wire_input_x(i)),
                wire(self.row, g.wire_input_y(i)),
                wire(self.row, g.wire_input_borrow(i))]

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        x = witness.get(wire(self.row, g.wire_input_x(i)))
        y = witness.get(wire(self.row, g.wire_input_y(i)))
        b = witness.get(wire(self.row, g.wire_input_borrow(i)))
        diff = x - y - b
        borrow = 1 if diff < 0 else 0
        result = diff + (borrow << 32)
        out.append((wire(self.row, g.wire_output_result(i)), result))
        out.append((wire(self.row, g.wire_output_borrow(i)), borrow))
        v = result
        for j in range(g.NUM_LIMBS):
            out.append((wire(self.row, g.wire_limb(i, j)),
                        v % (1 << g.LIMB_BITS)))
            v >>= g.LIMB_BITS


class ComparisonGate(Gate):
    """first <= second over num_bits-bit values, via base-2^chunk_bits chunk
    decomposition and a most-significant-differing-chunk scan
    (reference: u32/src/gates/comparison.rs:40-410)."""

    def __init__(self, num_bits: int, num_chunks: int):
        self.num_bits = num_bits
        self.num_chunks = num_chunks

    def chunk_bits(self):
        return -(-self.num_bits // self.num_chunks)

    def id(self):
        return (f"ComparisonGate {{ num_bits: {self.num_bits}, "
                f"num_chunks: {self.num_chunks} }}")

    def wire_first_input(self):
        return 0

    def wire_second_input(self):
        return 1

    def wire_result_bool(self):
        return 2

    def wire_most_significant_diff(self):
        return 3

    def wire_first_chunk_val(self, chunk):
        return 4 + chunk

    def wire_second_chunk_val(self, chunk):
        return 4 + self.num_chunks + chunk

    def wire_equality_dummy(self, chunk):
        return 4 + 2 * self.num_chunks + chunk

    def wire_chunks_equal(self, chunk):
        return 4 + 3 * self.num_chunks + chunk

    def wire_intermediate_value(self, chunk):
        return 4 + 4 * self.num_chunks + chunk

    def wire_most_significant_diff_bit(self, bit_index):
        return 4 + 5 * self.num_chunks + bit_index

    def num_wires(self):
        return 4 + 5 * self.num_chunks + self.chunk_bits() + 1

    def degree(self):
        return 1 << self.chunk_bits()

    def num_constraints(self):
        return 6 + 5 * self.num_chunks + self.chunk_bits()

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        out = []
        one = alg.const(1)
        first = wires[self.wire_first_input()]
        second = wires[self.wire_second_input()]
        first_chunks = [wires[self.wire_first_chunk_val(i)]
                        for i in range(self.num_chunks)]
        second_chunks = [wires[self.wire_second_chunk_val(i)]
                         for i in range(self.num_chunks)]
        base = 1 << self.chunk_bits()

        def combine(chunks, b):
            acc = alg.zero()
            for c in reversed(chunks):
                acc = alg.add(alg.mul_const(acc, b), c)
            return acc

        out.append(alg.sub(combine(first_chunks, base), first))
        out.append(alg.sub(combine(second_chunks, base), second))

        msd_so_far = alg.zero()
        for i in range(self.num_chunks):
            for chunk in (first_chunks[i], second_chunks[i]):
                prod = None
                for x in range(base):
                    t = alg.add_const(chunk, (-x) % ref.ORDER)
                    prod = t if prod is None else alg.mul(prod, t)
                out.append(prod)
            difference = alg.sub(second_chunks[i], first_chunks[i])
            equality_dummy = wires[self.wire_equality_dummy(i)]
            chunks_equal = wires[self.wire_chunks_equal(i)]
            out.append(alg.sub(alg.mul(difference, equality_dummy),
                               alg.sub(one, chunks_equal)))
            out.append(alg.mul(chunks_equal, difference))
            intermediate = wires[self.wire_intermediate_value(i)]
            out.append(alg.sub(intermediate, alg.mul(chunks_equal, msd_so_far)))
            msd_so_far = alg.add(
                intermediate, alg.mul(alg.sub(one, chunks_equal), difference))

        msd = wires[self.wire_most_significant_diff()]
        out.append(alg.sub(msd, msd_so_far))

        bits = [wires[self.wire_most_significant_diff_bit(i)]
                for i in range(self.chunk_bits() + 1)]
        for bit in bits:
            out.append(alg.mul(bit, alg.sub(one, bit)))
        bits_combined = combine(bits, 2)
        out.append(alg.sub(alg.add_const(msd, base), bits_combined))
        out.append(alg.sub(wires[self.wire_result_bool()],
                           bits[self.chunk_bits()]))
        return out

    def generators(self, row, local_constants):
        return [_ComparisonGenerator(row, self)]


class _ComparisonGenerator(SimpleGenerator):
    def __init__(self, row, gate):
        self.row, self.gate = row, gate

    def dependencies(self):
        return [wire(self.row, self.gate.wire_first_input()),
                wire(self.row, self.gate.wire_second_input())]

    def run_once(self, witness, out):
        g = self.gate
        first = witness.get(wire(self.row, g.wire_first_input()))
        second = witness.get(wire(self.row, g.wire_second_input()))
        out.append((wire(self.row, g.wire_result_bool()),
                    1 if first <= second else 0))
        size = 1 << g.chunk_bits()
        fc, sc = [], []
        a, b = first, second
        for _ in range(g.num_chunks):
            fc.append(a % size)
            sc.append(b % size)
            a //= size
            b //= size
        msd_so_far = 0
        for i in range(g.num_chunks):
            eq = fc[i] == sc[i]
            diff = (sc[i] - fc[i]) % ref.ORDER
            out.append((wire(self.row, g.wire_first_chunk_val(i)), fc[i]))
            out.append((wire(self.row, g.wire_second_chunk_val(i)), sc[i]))
            out.append((wire(self.row, g.wire_equality_dummy(i)),
                        1 if eq else ref.inverse(diff)))
            out.append((wire(self.row, g.wire_chunks_equal(i)),
                        1 if eq else 0))
            out.append((wire(self.row, g.wire_intermediate_value(i)),
                        msd_so_far if eq else 0))
            if not eq:
                msd_so_far = diff
        out.append((wire(self.row, g.wire_most_significant_diff()),
                    msd_so_far))
        v = (size + msd_so_far) % ref.ORDER
        for i in range(g.chunk_bits() + 1):
            out.append((wire(self.row, g.wire_most_significant_diff_bit(i)),
                        v & 1))
            v >>= 1


class U32RangeCheckGate(Gate):
    """Range-check num_input_limbs values to 32 bits via base-4 aux limbs
    (reference: u32/src/gates/range_check_u32.rs:33-182)."""

    AUX_LIMB_BITS = 2
    BASE = 1 << AUX_LIMB_BITS
    AUX_PER_INPUT = 32 // AUX_LIMB_BITS

    def __init__(self, num_input_limbs: int):
        self.num_input_limbs = num_input_limbs

    def id(self):
        return f"U32RangeCheckGate {{ num_input_limbs: {self.num_input_limbs} }}"

    def wire_ith_input_limb(self, i):
        return i

    def wire_ith_input_limb_jth_aux_limb(self, i, j):
        return self.num_input_limbs + self.AUX_PER_INPUT * i + j

    def num_wires(self):
        return self.num_input_limbs * (1 + self.AUX_PER_INPUT)

    def degree(self):
        return self.BASE

    def num_constraints(self):
        return self.num_input_limbs * (1 + self.AUX_PER_INPUT)

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        out = []
        for i in range(self.num_input_limbs):
            input_limb = wires[self.wire_ith_input_limb(i)]
            aux = [wires[self.wire_ith_input_limb_jth_aux_limb(i, j)]
                   for j in range(self.AUX_PER_INPUT)]
            acc = alg.zero()
            for limb in reversed(aux):
                acc = alg.add(alg.mul_const(acc, self.BASE), limb)
            out.append(alg.sub(acc, input_limb))
            for limb in aux:
                prod = None
                for x in range(self.BASE):
                    t = alg.add_const(limb, (-x) % ref.ORDER)
                    prod = t if prod is None else alg.mul(prod, t)
                out.append(prod)
        return out

    def generators(self, row, local_constants):
        return [_U32RangeCheckGenerator(row, self)]


class _U32RangeCheckGenerator(SimpleGenerator):
    def __init__(self, row, gate):
        self.row, self.gate = row, gate

    def dependencies(self):
        g = self.gate
        return [wire(self.row, g.wire_ith_input_limb(i))
                for i in range(g.num_input_limbs)]

    def run_once(self, witness, out):
        g = self.gate
        for i in range(g.num_input_limbs):
            v = witness.get(wire(self.row, g.wire_ith_input_limb(i)))
            for j in range(g.AUX_PER_INPUT):
                out.append((wire(self.row,
                                 g.wire_ith_input_limb_jth_aux_limb(i, j)),
                            v % g.BASE))
                v //= g.BASE


# ---------------------------------------------------------------------------
# CircuitBuilderU32 gadgets (reference: u32/src/gadgets/arithmetic_u32.rs)
# ---------------------------------------------------------------------------

class U32Gadgets:
    """Mixin for CircuitBuilder. A U32Target is a base Target whose value is
    constrained (by the producing gate) to fit in 32 bits."""

    def add_virtual_u32_target(self):
        return self.add_virtual_target()

    def constant_u32(self, c: int):
        assert 0 <= c <= U32_MAX
        return self.constant(c)

    def zero_u32(self):
        return self.zero()

    def one_u32(self):
        return self.one()

    def mul_add_u32(self, a, b, c):
        """(a*b + c) -> (low, high) U32Targets."""
        gate = U32ArithmeticGate.from_config(self.config)
        row, i = self.find_slot(gate, ("u32arith",), [])
        self.connect(a, wire(row, gate.wire_multiplicand_0(i)))
        self.connect(b, wire(row, gate.wire_multiplicand_1(i)))
        self.connect(c, wire(row, gate.wire_addend(i)))
        return (wire(row, gate.wire_output_low(i)),
                wire(row, gate.wire_output_high(i)))

    def mul_u32(self, a, b):
        return self.mul_add_u32(a, b, self.zero())

    def add_u32(self, a, b):
        return self.add_many_u32([a, b])

    def add_many_u32(self, addends: list, carry=None):
        """(sum + carry) -> (result, carry_out)."""
        assert 2 <= len(addends) <= 16
        carry = carry if carry is not None else self.zero()
        gate = U32AddManyGate.from_config(self.config, len(addends))
        row, i = self.find_slot(gate, ("u32add", len(addends)), [])
        for j, a in enumerate(addends):
            self.connect(a, wire(row, gate.wire_addend(i, j)))
        self.connect(carry, wire(row, gate.wire_carry(i)))
        return (wire(row, gate.wire_output_result(i)),
                wire(row, gate.wire_output_carry(i)))

    def sub_u32(self, x, y, borrow=None):
        """(x - y - borrow) -> (result, borrow_out)."""
        borrow = borrow if borrow is not None else self.zero()
        gate = U32SubtractionGate.from_config(self.config)
        row, i = self.find_slot(gate, ("u32sub",), [])
        self.connect(x, wire(row, gate.wire_input_x(i)))
        self.connect(y, wire(row, gate.wire_input_y(i)))
        self.connect(borrow, wire(row, gate.wire_input_borrow(i)))
        return (wire(row, gate.wire_output_result(i)),
                wire(row, gate.wire_output_borrow(i)))

    def split_u64_to_u32(self, t):
        """Decompose a field element known < 2^64 into (low32, high32)."""
        lo, hi = self.mul_add_u32(self.zero(), self.zero(), t)
        return lo, hi

    def range_check_u32(self, targets: list):
        """Constrain each target to 32 bits
        (reference: u32/src/gadgets/range_check.rs:10-22)."""
        gate = U32RangeCheckGate(len(targets))
        row = self.add_gate(gate, [])
        for i, t in enumerate(targets):
            self.connect(t, wire(row, gate.wire_ith_input_limb(i)))

    def list_le(self, a: list, b: list, num_bits: int):
        """BoolTarget for a <= b as little-endian equal-width limb lists
        (reference: u32/src/gadgets/multiple_comparison.rs:15-50)."""
        assert len(a) == len(b)
        num_chunks = -(-num_bits // 2)
        one = self.one()
        result = one
        for x, y in zip(a, b):
            g1 = ComparisonGate(num_bits, num_chunks)
            r1 = self.add_gate(g1, [])
            self.connect(wire(r1, g1.wire_first_input()), x)
            self.connect(wire(r1, g1.wire_second_input()), y)
            a_le_b = wire(r1, g1.wire_result_bool())
            g2 = ComparisonGate(num_bits, num_chunks)
            r2 = self.add_gate(g2, [])
            self.connect(wire(r2, g2.wire_first_input()), y)
            self.connect(wire(r2, g2.wire_second_input()), x)
            b_le_a = wire(r2, g2.wire_result_bool())
            limbs_equal = self.mul(a_le_b, b_le_a)
            limbs_less = self.sub(one, b_le_a)
            result = self.mul_add(limbs_equal, result, limbs_less)
        return result

    def list_le_u32(self, a: list, b: list):
        return self.list_le(a, b, 32)