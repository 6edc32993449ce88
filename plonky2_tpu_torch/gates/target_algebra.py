"""TargetAlgebra — evaluation algebra whose elements are ExtensionTargets.

Feeding this into the SAME `Gate.eval_unfiltered` used by the prover and
verifier yields the in-circuit constraint evaluation (the reference's
hand-written eval_unfiltered_circuit per gate, gates/gate.rs:132), with
constraint order guaranteed identical by construction.
"""

from __future__ import annotations

from ..field import reference as ref


class TargetAlgebra:
    def __init__(self, builder):
        self.b = builder

    def add(self, a, b):
        return self.b.add_extension(a, b)

    def sub(self, a, b):
        return self.b.sub_extension(a, b)

    def mul(self, a, b):
        return self.b.mul_extension(a, b)

    def mul_const(self, a, c: int):
        return self.b.mul_const_extension(c % ref.ORDER, a)

    def add_const(self, a, c: int):
        return self.b.add_const_extension(a, c % ref.ORDER)

    def const(self, c: int):
        return self.b.constant_extension((c % ref.ORDER, 0))

    def zero(self):
        return self.b.zero_extension()
