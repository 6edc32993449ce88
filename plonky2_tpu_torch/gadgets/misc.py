"""Misc gadgets: random access, split_le, reducing factors, coset
interpolation, select, exp.

Reference: plonky2/src/gadgets/{random_access.rs, split_base.rs,
select.rs}, util/reducing.rs (ReducingFactorTarget), gadgets/interpolation.rs.
"""

from __future__ import annotations

from ..field import reference as ref
from ..gates.coset_interpolation_gate import CosetInterpolationGate
from ..gates.extension_gates import (
    ArithmeticExtensionGate, ReducingExtensionGate, ReducingGate,
)
from ..gates.misc_gates import BaseSumGate, ExponentiationGate, RandomAccessGate
from ..iop.target import ExtTarget, wire


class MiscGadgets:
    """Mixin for CircuitBuilder."""

    # -- selection --------------------------------------------------------------
    def select(self, cond, a, b):
        """cond ? a : b = b + cond * (a - b) in two arithmetic ops."""
        diff = self.sub(a, b)
        return self.mul_add(cond, diff, b)

    def random_access(self, access_index, v: list):
        """v[access_index] via RandomAccessGate; len(v) must be a power of 2
        (callers pad)."""
        vec_size = len(v)
        bits = (vec_size - 1).bit_length()
        assert 1 << bits == vec_size, "random_access requires power-of-2 list"
        if vec_size == 1:
            return v[0]
        claimed = self.add_virtual_target()
        gate = RandomAccessGate.from_config(self.config, bits)
        row, copy = self.find_slot(gate, (bits,), [])
        for i, val in enumerate(v):
            self.connect(val, wire(row, gate.wire_list_item(i, copy)))
        self.connect(access_index, wire(row, gate.wire_access_index(copy)))
        self.connect(claimed, wire(row, gate.wire_claimed_element(copy)))
        return claimed

    def random_access_extension(self, access_index, v: list) -> ExtTarget:
        c0 = self.random_access(access_index, [e[0] for e in v])
        c1 = self.random_access(access_index, [e[1] for e in v])
        return ExtTarget(c0, c1)

    # -- bit decomposition --------------------------------------------------------
    def split_le(self, integer, num_bits: int) -> list:
        """Little-endian bit decomposition via BaseSumGate(2)
        (reference: gadgets/split_base.rs split_le_base + hashing usage)."""
        if num_bits == 0:
            return []
        gate = BaseSumGate(num_bits, base=2)
        row = self.add_gate(gate, [])
        self.connect(integer, wire(row, gate.WIRE_SUM))
        return [wire(row, gate.START_LIMBS + i) for i in range(num_bits)]

    def le_sum(self, bits: list):
        """Recombine little-endian bits into a target. Needs the bits->sum
        generator (the gate's own generator computes the reverse split;
        reference: gadgets/split_join.rs le_sum + BaseSumGenerator)."""
        if not bits:
            return self.zero()
        gate = BaseSumGate(len(bits), base=2)
        row = self.add_gate(gate, [])
        for i, b in enumerate(bits):
            self.connect(b, wire(row, gate.START_LIMBS + i))
        self.add_simple_generator(_BaseSumGenerator(list(bits),
                                                    wire(row, gate.WIRE_SUM)))
        return wire(row, gate.WIRE_SUM)

    def assert_bool(self, b) -> None:
        """b * b == b."""
        prod = self.mul(b, b)
        self.connect(prod, b)

    # -- boolean logic (reference: gadgets/arithmetic.rs and/or/not) ---------
    def not_(self, b):
        return self.sub(self.one(), b)

    def and_(self, a, b):
        return self.mul(a, b)

    def or_(self, a, b):
        # a + b - a*b
        return self.sub(self.add(a, b), self.mul(a, b))

    def is_equal(self, x, y):
        """BoolTarget for x == y (reference: gadgets/arithmetic.rs:362-380,
        EqualityGenerator)."""
        equal = self.add_virtual_target()
        inv = self.add_virtual_target()
        self.add_simple_generator(_EqualityGenerator(x, y, equal, inv))
        diff = self.sub(x, y)
        not_equal = self.not_(equal)
        self.assert_zero(self.mul(equal, diff))
        self.assert_zero(self.sub(self.mul(diff, inv), not_equal))
        return equal

    # -- exponentiation ------------------------------------------------------------
    def exp_from_bits(self, base, exponent_bits: list):
        gate = ExponentiationGate(len(exponent_bits))
        row = self.add_gate(gate, [])
        self.connect(base, wire(row, gate.wire_base()))
        for i, b in enumerate(exponent_bits):
            self.connect(b, wire(row, gate.wire_power_bit(i)))
        return wire(row, gate.wire_output())

    def exp_from_bits_const_base(self, base: int, exponent_bits: list):
        """base^(bits) for a compile-time base: product *= 1+bit(base^2^i - 1)
        (reference: gadgets/arithmetic.rs:278-306)."""
        if len(exponent_bits) > self.config.num_routed_wires // 4:
            return self.exp_from_bits(self.constant(base), exponent_bits)
        product = self.one()
        for i, bit in enumerate(exponent_bits):
            pow_ = ref.exp(base, 1 << i)
            product = self.arithmetic(ref.sub(pow_, 1), 1, product, bit,
                                      product)
        return product

    def exp_power_of_2_base(self, base, power_log: int):
        for _ in range(power_log):
            base = self.mul(base, base)
        return base

    def mul_const_add(self, c: int, a, b):
        """c*a + b."""
        return self.arithmetic(c, 1, a, self.one(), b)

    def range_check(self, x, n_log: int) -> None:
        self.split_le(x, n_log)

    def low_bits(self, x, num_low_bits: int, num_bits: int) -> list:
        bits = self.split_le(x, num_bits)
        return bits[:num_low_bits]

    def assert_leading_zeros(self, x, n: int) -> None:
        self.range_check(x, 64 - n)

    # -- in-circuit Merkle verification -----------------------------------------
    def verify_merkle_proof_to_cap_with_cap_index(self, leaf_data: list,
                                                  leaf_index_bits: list,
                                                  cap_index, merkle_cap: list,
                                                  siblings: list) -> None:
        """reference: hash/merkle_proofs.rs:114-152."""
        zero = self.zero()
        state = self.hash_or_noop(list(leaf_data))
        for bit, sibling in zip(leaf_index_bits, siblings):
            perm_in = list(state) + list(sibling) + [zero] * 4
            state = self.permute_swapped(perm_in, bit)[:4]
        for i in range(4):
            got = self.random_access(cap_index,
                                     [h[i] for h in merkle_cap])
            self.connect(got, state[i])

    def exp_u64_target(self, base, e: int):
        """base^e for a compile-time constant exponent."""
        result = self.one()
        b = base
        while e:
            if e & 1:
                result = self.mul(result, b)
            e >>= 1
            if e:
                b = self.mul(b, b)
        return result

    # -- coset interpolation ----------------------------------------------------
    def interpolate_coset(self, subgroup_bits: int, coset_shift,
                          values: list, evaluation_point: ExtTarget
                          ) -> ExtTarget:
        gate = CosetInterpolationGate(
            subgroup_bits, self.config.max_quotient_degree_factor)
        row = self.add_gate(gate, [])
        self.connect(coset_shift, wire(row, gate.wire_shift()))
        for i, v in enumerate(values):
            self.connect_extension(
                v, ExtTarget(*(wire(row, w) for w in gate.wires_value(i))))
        self.connect_extension(
            evaluation_point,
            ExtTarget(*(wire(row, w) for w in gate.wires_evaluation_point())))
        return ExtTarget(*(wire(row, w)
                           for w in gate.wires_evaluation_value()))


class _BaseSumGenerator:
    """sum = sum_i bits[i] * 2^i from the bit targets."""

    def __init__(self, bits, sum_target):
        self.bits = bits
        self.sum_target = sum_target

    def watch_list(self):
        return list(self.bits)

    def run(self, witness, out):
        if not all(witness.is_set(b) for b in self.bits):
            return False
        total = sum(witness.get(b) << i for i, b in enumerate(self.bits))
        out.append((self.sum_target, total % ref.ORDER))
        return True


class ReducingFactorTarget:
    """Horner accumulator over alpha using Reducing(Extension) gates
    (reference: util/reducing.rs:113-266)."""

    def __init__(self, base: ExtTarget):
        self.base = base
        self.count = 0

    def _reduce_arithmetic(self, builder, terms_ext):
        self.count += len(terms_ext)
        acc = builder.zero_extension()
        for t in reversed(terms_ext):
            acc = builder.mul_add_extension(self.base, acc, t)
        return acc

    def reduce_base(self, terms: list, builder) -> ExtTarget:
        l = len(terms)
        arith_ops = ArithmeticExtensionGate.from_config(builder.config) \
            .num_ops()
        if l <= arith_ops + 1:
            return self._reduce_arithmetic(
                builder, [builder.convert_to_ext(t) for t in terms])
        max_len = ReducingGate.max_coeffs_len(builder.config.num_wires,
                                              builder.config.num_routed_wires)
        self.count += l
        zero = builder.zero()
        acc = builder.zero_extension()
        rev = list(terms)
        while len(rev) % max_len != 0:
            rev.append(zero)
        rev.reverse()
        for k in range(0, len(rev), max_len):
            chunk = rev[k:k + max_len]
            gate = ReducingGate(max_len)
            row = builder.add_gate(gate, [])
            builder.connect_extension(
                self.base,
                ExtTarget(*(wire(row, w) for w in gate.wires_alpha())))
            builder.connect_extension(
                acc, ExtTarget(*(wire(row, w) for w in gate.wires_old_acc())))
            for t, c in zip(chunk, gate.wires_coeffs()):
                builder.connect(t, wire(row, c))
            acc = ExtTarget(*(wire(row, w) for w in gate.wires_output()))
        return acc

    def reduce(self, terms: list, builder) -> ExtTarget:
        l = len(terms)
        arith_ops = ArithmeticExtensionGate.from_config(builder.config) \
            .num_ops()
        if l <= arith_ops + 1:
            return self._reduce_arithmetic(builder, list(terms))
        max_len = ReducingExtensionGate.max_coeffs_len(
            builder.config.num_wires, builder.config.num_routed_wires)
        self.count += l
        zero_ext = builder.zero_extension()
        acc = builder.zero_extension()
        rev = list(terms)
        while len(rev) % max_len != 0:
            rev.append(zero_ext)
        rev.reverse()
        for k in range(0, len(rev), max_len):
            chunk = rev[k:k + max_len]
            gate = ReducingExtensionGate(max_len)
            row = builder.add_gate(gate, [])
            builder.connect_extension(
                self.base,
                ExtTarget(*(wire(row, w) for w in gate.wires_alpha())))
            builder.connect_extension(
                acc, ExtTarget(*(wire(row, w) for w in gate.wires_old_acc())))
            for t, crange in zip(chunk,
                                 [gate.wires_coeff(i)
                                  for i in range(gate.num_coeffs)]):
                builder.connect_extension(
                    t, ExtTarget(*(wire(row, w) for w in crange)))
            acc = ExtTarget(*(wire(row, w) for w in gate.wires_output()))
        return acc

    def shift(self, x: ExtTarget, builder) -> ExtTarget:
        exp = builder.exp_u64_extension(self.base, self.count)
        self.count = 0
        return builder.mul_extension(exp, x)


class _EqualityGenerator:
    """equal = (x == y); inv = 1/(x-y) or 0
    (reference: gadgets/arithmetic.rs EqualityGenerator)."""

    def __init__(self, x, y, equal, inv):
        self.x, self.y, self.equal, self.inv = x, y, equal, inv

    def watch_list(self):
        return [self.x, self.y]

    def run(self, witness, out):
        if not (witness.is_set(self.x) and witness.is_set(self.y)):
            return False
        diff = ref.sub(witness.get(self.x), witness.get(self.y))
        out.append((self.equal, 0 if diff else 1))
        out.append((self.inv, ref.inverse(diff) if diff else 0))
        return True
