"""Extension-target gadgets mixed into CircuitBuilder.

Reference: plonky2/src/gadgets/arithmetic_extension.rs (arithmetic_extension
slot packing + special cases), iop/ext_target.rs. An ExtensionTarget is a
(c0, c1) pair of base targets.
"""

from __future__ import annotations

from ..field import reference as ref
from ..gates.extension_gates import ArithmeticExtensionGate, MulExtensionGate
from ..iop.target import ExtTarget, wire


class ExtensionGadgets:
    """Mixin for CircuitBuilder (self is the builder)."""

    def add_virtual_extension_target(self) -> ExtTarget:
        return ExtTarget(self.add_virtual_target(), self.add_virtual_target())

    def add_virtual_extension_targets(self, n: int):
        return [self.add_virtual_extension_target() for _ in range(n)]

    def constant_extension(self, c) -> ExtTarget:
        c0, c1 = c
        return ExtTarget(self.constant(c0), self.constant(c1))

    def zero_extension(self) -> ExtTarget:
        return self.constant_extension((0, 0))

    def one_extension(self) -> ExtTarget:
        return self.constant_extension((1, 0))

    def convert_to_ext(self, t) -> ExtTarget:
        return ExtTarget(t, self.zero())

    def connect_extension(self, a: ExtTarget, b: ExtTarget) -> None:
        self.connect(a[0], b[0])
        self.connect(a[1], b[1])

    def target_as_constant_ext(self, t: ExtTarget):
        c0 = self.target_as_constant(t[0])
        c1 = self.target_as_constant(t[1])
        if c0 is not None and c1 is not None:
            return (c0, c1)
        return None

    # -- core op: c0*a*b + c1*addend via ArithmeticExtensionGate slots --------
    def arithmetic_extension(self, const_0: int, const_1: int, a: ExtTarget,
                             b: ExtTarget, addend: ExtTarget) -> ExtTarget:
        const_0 %= ref.ORDER
        const_1 %= ref.ORDER
        ca, cb, cad = (self.target_as_constant_ext(a),
                       self.target_as_constant_ext(b),
                       self.target_as_constant_ext(addend))
        if ca is not None and cb is not None and cad is not None:
            val = ref.ext2_add(
                ref.ext2_scalar_mul(ref.ext2_mul(ca, cb), const_0),
                ref.ext2_scalar_mul(cad, const_1))
            return self.constant_extension(val)

        key = ("ae", const_0, const_1, a, b, addend)
        if key in self.base_arithmetic_results:
            return self.base_arithmetic_results[key]
        gate = ArithmeticExtensionGate.from_config(self.config)
        row, i = self.find_slot(gate, (const_0, const_1), [const_0, const_1])
        conn = lambda t, rng: self.connect_extension(
            t, ExtTarget(*(wire(row, w) for w in rng)))
        conn(a, gate.wires_multiplicand_0(i))
        conn(b, gate.wires_multiplicand_1(i))
        conn(addend, gate.wires_addend(i))
        out = ExtTarget(*(wire(row, w) for w in gate.wires_output(i)))
        self.base_arithmetic_results[key] = out
        return out

    def mul_extension_with_const(self, const_0: int, a: ExtTarget,
                                 b: ExtTarget) -> ExtTarget:
        const_0 %= ref.ORDER
        ca, cb = self.target_as_constant_ext(a), self.target_as_constant_ext(b)
        if ca is not None and cb is not None:
            return self.constant_extension(
                ref.ext2_scalar_mul(ref.ext2_mul(ca, cb), const_0))
        key = ("me", const_0, a, b)
        if key in self.base_arithmetic_results:
            return self.base_arithmetic_results[key]
        gate = MulExtensionGate.from_config(self.config)
        row, i = self.find_slot(gate, (const_0,), [const_0])
        conn = lambda t, rng: self.connect_extension(
            t, ExtTarget(*(wire(row, w) for w in rng)))
        conn(a, gate.wires_multiplicand_0(i))
        conn(b, gate.wires_multiplicand_1(i))
        out = ExtTarget(*(wire(row, w) for w in gate.wires_output(i)))
        self.base_arithmetic_results[key] = out
        return out

    # -- derived ops -----------------------------------------------------------
    def add_extension(self, a, b):
        return self.arithmetic_extension(1, 1, a, self.one_extension(), b)

    def sub_extension(self, a, b):
        return self.arithmetic_extension(1, ref.ORDER - 1, a,
                                         self.one_extension(), b)

    def mul_extension(self, a, b):
        return self.mul_extension_with_const(1, a, b)

    def mul_add_extension(self, a, b, c):
        return self.arithmetic_extension(1, 1, a, b, c)

    def mul_sub_extension(self, a, b, c):
        """a*b - c."""
        return self.arithmetic_extension(1, ref.ORDER - 1, a, b, c)

    def scalar_mul_ext(self, s, a: ExtTarget) -> ExtTarget:
        """s (base Target) * a."""
        return self.mul_extension(self.convert_to_ext(s), a)

    def mul_const_extension(self, c: int, a: ExtTarget) -> ExtTarget:
        return self.arithmetic_extension(c, 0, a, self.one_extension(),
                                         self.zero_extension())

    def mul_const_add_extension(self, c: int, a: ExtTarget,
                                b: ExtTarget) -> ExtTarget:
        """c*a + b."""
        return self.arithmetic_extension(c, 1, a, self.one_extension(), b)

    def add_const_extension(self, a: ExtTarget, c: int) -> ExtTarget:
        return self.add_extension(a, self.constant_extension((c, 0)))

    def add_many_extension(self, terms):
        acc = self.zero_extension()
        for t in terms:
            acc = self.add_extension(acc, t)
        return acc

    def mul_many_extension(self, terms):
        terms = list(terms)
        acc = terms[0]
        for t in terms[1:]:
            acc = self.mul_extension(acc, t)
        return acc

    def square_extension(self, a):
        return self.mul_extension(a, a)

    def exp_power_of_2_extension(self, a, k: int):
        for _ in range(k):
            a = self.square_extension(a)
        return a

    def exp_u64_extension(self, a, e: int):
        result = self.one_extension()
        base = a
        while e:
            if e & 1:
                result = self.mul_extension(result, base)
            e >>= 1
            if e:
                base = self.square_extension(base)
        return result

    def inverse_extension(self, x: ExtTarget) -> ExtTarget:
        x_inv = self.add_virtual_extension_target()
        self.add_simple_generator(_ExtInverseGenerator(x, x_inv))
        prod = self.mul_extension(x, x_inv)
        self.connect_extension(prod, self.one_extension())
        return x_inv

    def div_extension(self, a, b):
        return self.mul_extension(a, self.inverse_extension(b))

    def div_add_extension(self, x, y, z):
        """x/y + z (reference: gadgets/arithmetic_extension.rs:474-497)."""
        y_inv = self.inverse_extension(y)
        return self.mul_add_extension(x, y_inv, z)

    def select_ext(self, cond, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        """cond ? a : b for a BoolTarget cond = b + cond*(a-b)."""
        ce = self.convert_to_ext(cond)
        diff = self.sub_extension(a, b)
        return self.mul_add_extension(ce, diff, b)

    def frobenius_ext(self, a: ExtTarget) -> ExtTarget:
        """x -> x^p: (c0, DTH_ROOT * c1), DTH_ROOT = p - 1."""
        c1 = self.mul_const(ref.ORDER - 1, a[1])
        return ExtTarget(a[0], c1)


class _ExtInverseGenerator:
    def __init__(self, x: ExtTarget, x_inv: ExtTarget):
        self.x, self.x_inv = x, x_inv

    def watch_list(self):
        return [self.x[0], self.x[1]]

    def run(self, witness, out):
        if not (witness.is_set(self.x[0]) and witness.is_set(self.x[1])):
            return False
        v = (witness.get(self.x[0]), witness.get(self.x[1]))
        inv = ref.ext2_inverse(v) if v != (0, 0) else (0, 0)
        out.append((self.x_inv[0], inv[0]))
        out.append((self.x_inv[1], inv[1]))
        return True
