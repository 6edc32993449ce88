"""BigUintTarget: arbitrary-precision unsigned integers as u32 limb lists.

Reference: ecdsa/src/gadgets/biguint.rs — BigUintTarget (:31-44),
CircuitBuilderBiguint (:46-260: add/sub/mul/cmp/div_rem via u32 gates),
BigUintDivRemGenerator (:300-350), witness helpers (:262-298).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BigUintTarget:
    limbs: tuple   # little-endian u32 targets

    def num_limbs(self) -> int:
        return len(self.limbs)

    def get_limb(self, i: int):
        return self.limbs[i]


class BigUintGadgets:
    """Mixin for CircuitBuilder."""

    def constant_biguint(self, value: int) -> BigUintTarget:
        limbs = []
        v = value
        while v:
            limbs.append(self.constant_u32(v & 0xFFFFFFFF))
            v >>= 32
        if not limbs:
            limbs.append(self.zero_u32())
        return BigUintTarget(tuple(limbs))

    def zero_biguint(self) -> BigUintTarget:
        return self.constant_biguint(0)

    def add_virtual_biguint_target(self, num_limbs: int) -> BigUintTarget:
        return BigUintTarget(tuple(self.add_virtual_target()
                                   for _ in range(num_limbs)))

    def connect_biguint(self, lhs: BigUintTarget, rhs: BigUintTarget) -> None:
        n = min(lhs.num_limbs(), rhs.num_limbs())
        for i in range(n):
            self.connect(lhs.limbs[i], rhs.limbs[i])
        for i in range(n, lhs.num_limbs()):
            self.assert_zero(lhs.limbs[i])
        for i in range(n, rhs.num_limbs()):
            self.assert_zero(rhs.limbs[i])

    def pad_biguints(self, a: BigUintTarget, b: BigUintTarget):
        if a.num_limbs() > b.num_limbs():
            pad = (self.zero_u32(),) * (a.num_limbs() - b.num_limbs())
            return a, BigUintTarget(b.limbs + pad)
        pad = (self.zero_u32(),) * (b.num_limbs() - a.num_limbs())
        return BigUintTarget(a.limbs + pad), b

    def cmp_biguint(self, a: BigUintTarget, b: BigUintTarget):
        """BoolTarget for a <= b."""
        a, b = self.pad_biguints(a, b)
        return self.list_le_u32(list(a.limbs), list(b.limbs))

    def is_zero_biguint(self, a: BigUintTarget):
        acc = self.one()
        zero = self.zero()
        for limb in a.limbs:
            acc = self.and_(acc, self.is_equal(limb, zero))
        return acc

    def add_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
        n = max(a.num_limbs(), b.num_limbs())
        zero = self.zero_u32()
        out = []
        carry = zero
        for i in range(n):
            la = a.limbs[i] if i < a.num_limbs() else zero
            lb = b.limbs[i] if i < b.num_limbs() else zero
            limb, carry = self.add_many_u32([carry, la, lb])
            out.append(limb)
        out.append(carry)
        return BigUintTarget(tuple(out))

    def sub_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
        """Assumes a >= b."""
        a, b = self.pad_biguints(a, b)
        out = []
        borrow = self.zero_u32()
        for la, lb in zip(a.limbs, b.limbs):
            limb, borrow = self.sub_u32(la, lb, borrow)
            out.append(limb)
        return BigUintTarget(tuple(out))

    def mul_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
        total = a.num_limbs() + b.num_limbs()
        to_add = [[] for _ in range(total)]
        for i, la in enumerate(a.limbs):
            for j, lb in enumerate(b.limbs):
                prod, carry = self.mul_u32(la, lb)
                to_add[i + j].append(prod)
                to_add[i + j + 1].append(carry)
        out = []
        carry = self.zero_u32()
        for summands in to_add:
            limb, carry = self.add_u32s_with_carry(summands, carry)
            out.append(limb)
        out.append(carry)
        return BigUintTarget(tuple(out))

    def add_u32s_with_carry(self, to_add: list, carry):
        if not to_add:
            return carry, self.zero_u32()
        if len(to_add) == 1:
            return self.add_many_u32([to_add[0], carry])
        return self.add_many_u32(list(to_add), carry)

    def mul_biguint_by_bool(self, a: BigUintTarget, b) -> BigUintTarget:
        return BigUintTarget(tuple(self.mul(l, b) for l in a.limbs))

    def mul_add_biguint(self, x, y, z) -> BigUintTarget:
        return self.add_biguint(self.mul_biguint(x, y), z)

    def div_rem_biguint(self, a: BigUintTarget, b: BigUintTarget):
        """(a // b, a % b) with in-circuit consistency checks."""
        a_len, b_len = a.num_limbs(), b.num_limbs()
        div_limbs = 0 if b_len > a_len + 1 else a_len - b_len + 1
        div = self.add_virtual_biguint_target(max(div_limbs, 1))
        rem = self.add_virtual_biguint_target(b_len)
        self.add_simple_generator(_BigUintDivRemGenerator(a, b, div, rem))
        div_b = self.mul_biguint(div, b)
        self.connect_biguint(a, self.add_biguint(div_b, rem))
        # rem < b  <=>  rem + 1 <= b  (b nonzero); the reference checks
        # rem <= b via cmp and relies on the division identity; keep parity:
        self.assert_one(self.cmp_biguint(rem, b))
        return div, rem

    def div_biguint(self, a, b):
        return self.div_rem_biguint(a, b)[0]

    def rem_biguint(self, a, b):
        return self.div_rem_biguint(a, b)[1]


# ---------------------------------------------------------------------------
# witness helpers (reference: biguint.rs:262-298)
# ---------------------------------------------------------------------------

def set_biguint_target(pw, target: BigUintTarget, value: int) -> None:
    for i in range(target.num_limbs()):
        pw.set_target(target.limbs[i], (value >> (32 * i)) & 0xFFFFFFFF)
    assert value >> (32 * target.num_limbs()) == 0, "value too large"


def get_biguint_target(witness, target: BigUintTarget) -> int:
    return sum(witness.get(l) << (32 * i)
               for i, l in enumerate(target.limbs))


class _BigUintDivRemGenerator:
    def __init__(self, a, b, div, rem):
        self.a, self.b, self.div, self.rem = a, b, div, rem

    def watch_list(self):
        return list(self.a.limbs) + list(self.b.limbs)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        a = get_biguint_target(witness, self.a)
        b = get_biguint_target(witness, self.b)
        div, rem = divmod(a, b)
        for i, t in enumerate(self.div.limbs):
            out.append((t, (div >> (32 * i)) & 0xFFFFFFFF))
        for i, t in enumerate(self.rem.limbs):
            out.append((t, (rem >> (32 * i)) & 0xFFFFFFFF))
        assert div >> (32 * self.div.num_limbs()) == 0
        return True
