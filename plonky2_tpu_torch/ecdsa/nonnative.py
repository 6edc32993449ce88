"""NonNativeTarget: arithmetic in a foreign prime field FF inside a
Goldilocks circuit, on top of BigUintTarget limbs.

Reference: ecdsa/src/gadgets/nonnative.rs — NonNativeTarget (:36-40),
CircuitBuilderNonNative (:46-450: add/sub/mul with witness-supplied
quotients + in-circuit identity checks, inverse via x*inv = 1 + div*|FF|),
generators (:453-700).

The modulus is carried on the target (the reference encodes it in the FF
type parameter)."""

from __future__ import annotations

import dataclasses

from .biguint import BigUintTarget, get_biguint_target


@dataclasses.dataclass(frozen=True)
class NonNativeTarget:
    value: BigUintTarget
    modulus: int

    def num_limbs(self) -> int:
        return self.value.num_limbs()


def _limbs_for(modulus: int) -> int:
    return -(-modulus.bit_length() // 32)


class NonNativeGadgets:
    """Mixin for CircuitBuilder."""

    def biguint_to_nonnative(self, x: BigUintTarget,
                             modulus: int) -> NonNativeTarget:
        return NonNativeTarget(x, modulus)

    def constant_nonnative(self, x: int, modulus: int) -> NonNativeTarget:
        x %= modulus
        limbs = [self.constant_u32((x >> (32 * i)) & 0xFFFFFFFF)
                 for i in range(_limbs_for(modulus))]
        return NonNativeTarget(BigUintTarget(tuple(limbs)), modulus)

    def zero_nonnative(self, modulus: int) -> NonNativeTarget:
        return self.constant_nonnative(0, modulus)

    def add_virtual_nonnative_target(self, modulus: int) -> NonNativeTarget:
        return NonNativeTarget(
            self.add_virtual_biguint_target(_limbs_for(modulus)), modulus)

    def connect_nonnative(self, a: NonNativeTarget,
                          b: NonNativeTarget) -> None:
        self.connect_biguint(a.value, b.value)

    def add_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        """reference: nonnative.rs:193-223."""
        m = a.modulus
        total = self.add_virtual_nonnative_target(m)
        overflow = self.add_virtual_target()
        self.add_simple_generator(
            _NonNativeAdditionGenerator(a, b, total, overflow))
        sum_expected = self.add_biguint(a.value, b.value)
        modulus = self.constant_biguint(m)
        mod_times_overflow = self.mul_biguint_by_bool(modulus, overflow)
        sum_actual = self.add_biguint(total.value, mod_times_overflow)
        self.connect_biguint(sum_expected, sum_actual)
        self.assert_one(self.cmp_biguint(total.value, modulus))
        return total

    def mul_nonnative_by_bool(self, a: NonNativeTarget, b) -> NonNativeTarget:
        return NonNativeTarget(self.mul_biguint_by_bool(a.value, b),
                               a.modulus)

    def if_nonnative(self, b, x: NonNativeTarget,
                     y: NonNativeTarget) -> NonNativeTarget:
        not_b = self.not_(b)
        maybe_x = self.mul_nonnative_by_bool(x, b)
        maybe_y = self.mul_nonnative_by_bool(y, not_b)
        return self.add_nonnative(maybe_x, maybe_y)

    def sub_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        """reference: nonnative.rs:286-313."""
        m = a.modulus
        diff = self.add_virtual_nonnative_target(m)
        overflow = self.add_virtual_target()
        self.add_simple_generator(
            _NonNativeSubtractionGenerator(a, b, diff, overflow))
        self.range_check_u32(list(diff.value.limbs))
        self.assert_bool(overflow)
        diff_plus_b = self.add_biguint(diff.value, b.value)
        modulus = self.constant_biguint(m)
        mod_times_overflow = self.mul_biguint_by_bool(modulus, overflow)
        reduced = self.sub_biguint(diff_plus_b, mod_times_overflow)
        self.connect_biguint(a.value, reduced)
        return diff

    def mul_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        """reference: nonnative.rs:314-344."""
        m = a.modulus
        prod = self.add_virtual_nonnative_target(m)
        modulus = self.constant_biguint(m)
        overflow = self.add_virtual_biguint_target(
            a.value.num_limbs() + b.value.num_limbs() - modulus.num_limbs())
        self.add_simple_generator(
            _NonNativeMultiplicationGenerator(a, b, prod, overflow))
        self.range_check_u32(list(prod.value.limbs))
        self.range_check_u32(list(overflow.limbs))
        prod_expected = self.mul_biguint(a.value, b.value)
        mod_times_overflow = self.mul_biguint(modulus, overflow)
        prod_actual = self.add_biguint(prod.value, mod_times_overflow)
        self.connect_biguint(prod_expected, prod_actual)
        return prod

    def neg_nonnative(self, x: NonNativeTarget) -> NonNativeTarget:
        zero = self.zero_nonnative(x.modulus)
        return self.sub_nonnative(zero, x)

    def inv_nonnative(self, x: NonNativeTarget) -> NonNativeTarget:
        """x * inv = 1 + div * |FF| (reference: nonnative.rs:366-392)."""
        m = x.modulus
        n = x.value.num_limbs()
        inv = self.add_virtual_biguint_target(n)
        div = self.add_virtual_biguint_target(n)
        self.add_simple_generator(_NonNativeInverseGenerator(x, inv, div))
        self.range_check_u32(list(inv.limbs))
        self.range_check_u32(list(div.limbs))
        product = self.mul_biguint(x.value, inv)
        modulus = self.constant_biguint(m)
        mod_times_div = self.mul_biguint(modulus, div)
        one = self.constant_biguint(1)
        expected = self.add_biguint(mod_times_div, one)
        self.connect_biguint(product, expected)
        return NonNativeTarget(inv, m)

    def div_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        return self.mul_nonnative(a, self.inv_nonnative(b))

    def reduce_biguint(self, x: BigUintTarget, modulus: int) -> NonNativeTarget:
        order = self.constant_biguint(modulus)
        return NonNativeTarget(self.rem_biguint(x, order), modulus)

    def bool_to_nonnative(self, b, modulus: int) -> NonNativeTarget:
        return NonNativeTarget(BigUintTarget((b,)), modulus)

    def split_nonnative_to_bits(self, x: NonNativeTarget) -> list:
        bits = []
        for limb in x.value.limbs:
            bits.extend(self.split_le(limb, 32))
        return bits

    def nonnative_conditional_neg(self, x: NonNativeTarget,
                                  b) -> NonNativeTarget:
        not_b = self.not_(b)
        neg = self.neg_nonnative(x)
        x_if_true = self.mul_nonnative_by_bool(neg, b)
        x_if_false = self.mul_nonnative_by_bool(x, not_b)
        return self.add_nonnative(x_if_true, x_if_false)


def set_nonnative_target(pw, t: NonNativeTarget, value: int) -> None:
    from .biguint import set_biguint_target
    set_biguint_target(pw, t.value, value % t.modulus)


def get_nonnative_target(witness, t: NonNativeTarget) -> int:
    return get_biguint_target(witness, t.value) % t.modulus


class _NonNativeAdditionGenerator:
    def __init__(self, a, b, sum_, overflow):
        self.a, self.b, self.sum, self.overflow = a, b, sum_, overflow

    def watch_list(self):
        return list(self.a.value.limbs) + list(self.b.value.limbs)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        m = self.a.modulus
        a = get_biguint_target(witness, self.a.value)
        b = get_biguint_target(witness, self.b.value)
        total = a + b
        overflow = 1 if total >= m else 0
        total -= overflow * m
        for i, t in enumerate(self.sum.value.limbs):
            out.append((t, (total >> (32 * i)) & 0xFFFFFFFF))
        out.append((self.overflow, overflow))
        return True


class _NonNativeSubtractionGenerator:
    def __init__(self, a, b, diff, overflow):
        self.a, self.b, self.diff, self.overflow = a, b, diff, overflow

    def watch_list(self):
        return list(self.a.value.limbs) + list(self.b.value.limbs)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        m = self.a.modulus
        a = get_biguint_target(witness, self.a.value)
        b = get_biguint_target(witness, self.b.value)
        overflow = 1 if a < b else 0
        diff = a + overflow * m - b
        for i, t in enumerate(self.diff.value.limbs):
            out.append((t, (diff >> (32 * i)) & 0xFFFFFFFF))
        out.append((self.overflow, overflow))
        return True


class _NonNativeMultiplicationGenerator:
    def __init__(self, a, b, prod, overflow):
        self.a, self.b, self.prod, self.overflow = a, b, prod, overflow

    def watch_list(self):
        return list(self.a.value.limbs) + list(self.b.value.limbs)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        m = self.a.modulus
        a = get_biguint_target(witness, self.a.value)
        b = get_biguint_target(witness, self.b.value)
        prod, overflow = (a * b) % m, (a * b) // m
        for i, t in enumerate(self.prod.value.limbs):
            out.append((t, (prod >> (32 * i)) & 0xFFFFFFFF))
        for i, t in enumerate(self.overflow.limbs):
            out.append((t, (overflow >> (32 * i)) & 0xFFFFFFFF))
        assert overflow >> (32 * self.overflow.num_limbs()) == 0
        return True


class _NonNativeInverseGenerator:
    def __init__(self, x, inv, div):
        self.x, self.inv, self.div = x, inv, div

    def watch_list(self):
        return list(self.x.value.limbs)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        m = self.x.modulus
        x = get_biguint_target(witness, self.x.value)
        inv = pow(x, m - 2, m)
        div = (x * inv - 1) // m
        for i, t in enumerate(self.inv.limbs):
            out.append((t, (inv >> (32 * i)) & 0xFFFFFFFF))
        for i, t in enumerate(self.div.limbs):
            out.append((t, (div >> (32 * i)) & 0xFFFFFFFF))
        return True
