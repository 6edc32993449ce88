"""Legacy interpolation gates.

Reference: plonky2/src/gates/interpolation.rs (the shared InterpolationGate
wire layout), high_degree_interpolation.rs:29-230 and
low_degree_interpolation.rs:29-520. Both interpolate a polynomial given its
values on the coset {shift * g^i} of the size-2^subgroup_bits two-adic
subgroup and evaluate it at an extension point. Superseded in the live
recursion path by CosetInterpolationGate, kept for reference parity.

Wire layout (shared, interpolation.rs:38-93):
  [0]                 shift (base)
  values              num_points * D
  evaluation_point    D
  evaluation_value    D
  coeffs              num_points * D
LowDegree appends intermediate power wires: shift^i (base, i=2..n-1) and
evaluation_point^i (ext, i=2..n-1) to cap the constraint degree at 2.
"""

from __future__ import annotations

from ..field import reference as ref
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from .ext_algebra import (
    ext_add, ext_from_base, ext_mul, ext_scalar_mul, ext_scalar_mul_const,
    ext_sub, ext_zero,
)
from .gate import Gate

D = 2


class _InterpolationBase(Gate):
    def __init__(self, subgroup_bits: int):
        self.subgroup_bits = subgroup_bits

    def num_points(self) -> int:
        return 1 << self.subgroup_bits

    # -- wire layout (reference: interpolation.rs:38-93) --------------------
    def wire_shift(self) -> int:
        return 0

    def start_values(self) -> int:
        return 1

    def wires_value(self, i: int) -> range:
        start = self.start_values() + i * D
        return range(start, start + D)

    def start_evaluation_point(self) -> int:
        return self.start_values() + self.num_points() * D

    def wires_evaluation_point(self) -> range:
        start = self.start_evaluation_point()
        return range(start, start + D)

    def wires_evaluation_value(self) -> range:
        start = self.start_evaluation_point() + D
        return range(start, start + D)

    def start_coeffs(self) -> int:
        return self.start_evaluation_point() + 2 * D

    def wires_coeff(self, i: int) -> range:
        start = self.start_coeffs() + i * D
        return range(start, start + D)

    def end_coeffs(self) -> int:
        return self.start_coeffs() + D * self.num_points()

    def num_constants(self) -> int:
        return 0

    def _subgroup(self) -> list[int]:
        g = ref.primitive_root_of_unity(self.subgroup_bits)
        out, cur = [], 1
        for _ in range(self.num_points()):
            out.append(cur)
            cur = ref.mul(cur, g)
        return out

    def generators(self, row, local_constants):
        return [_InterpolationGenerator(row, self)]


class HighDegreeInterpolationGate(_InterpolationBase):
    """reference: high_degree_interpolation.rs — variable constraint degree
    (num_points), fewest wires."""

    def id(self):
        return (f"HighDegreeInterpolationGate {{ subgroup_bits: "
                f"{self.subgroup_bits} }}<D=2>")

    def num_wires(self):
        return self.end_coeffs()

    def degree(self):
        # highest power of x is num_points-1, +1 for the coefficient mul
        return self.num_points()

    def num_constraints(self):
        return self.num_points() * D + D

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        n = self.num_points()
        coeffs = [tuple(wires[w] for w in self.wires_coeff(i))
                  for i in range(n)]
        shift = wires[self.wire_shift()]
        constraints = []
        # value_i == interpolant(shift * g^i); evaluate via Horner at the
        # base-algebra point shift*g^i (scalar for the ext-coeff polynomial)
        for i, g_i in enumerate(self._subgroup()):
            point = alg.mul_const(shift, g_i)
            acc = ext_zero(alg)
            for c in reversed(coeffs):
                acc = ext_add(alg, ext_scalar_mul(alg, acc, point), c)
            value = tuple(wires[w] for w in self.wires_value(i))
            constraints.extend(ext_sub(alg, value, acc))
        # evaluation_value == interpolant(evaluation_point), ext Horner
        point = tuple(wires[w] for w in self.wires_evaluation_point())
        acc = ext_zero(alg)
        for c in reversed(coeffs):
            acc = ext_add(alg, ext_mul(alg, acc, point), c)
        value = tuple(wires[w] for w in self.wires_evaluation_value())
        constraints.extend(ext_sub(alg, value, acc))
        return constraints


class LowDegreeInterpolationGate(_InterpolationBase):
    """reference: low_degree_interpolation.rs — constraint degree 2 via
    intermediate power wires."""

    def id(self):
        return (f"LowDegreeInterpolationGate {{ subgroup_bits: "
                f"{self.subgroup_bits} }}<D=2>")

    def powers_shift(self, i: int) -> int:
        """Wire of shift^i, i in 1..num_points (reference :51-57)."""
        assert 0 < i < self.num_points()
        if i == 1:
            return self.wire_shift()
        return self.end_coeffs() + i - 2

    def powers_evaluation_point(self, i: int) -> range:
        """Wires of evaluation_point^i (reference :60-66)."""
        assert 0 < i < self.num_points()
        if i == 1:
            return self.wires_evaluation_point()
        start = (self.end_coeffs() + self.num_points() - 2
                 + (i - 2) * D)
        return range(start, start + D)

    def num_wires(self):
        return (self.end_coeffs() + (self.num_points() - 2)
                + (self.num_points() - 2) * D)

    def degree(self):
        return 2

    def num_constraints(self):
        n = self.num_points()
        return n * D + D + (D + 1) * (n - 2)

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        n = self.num_points()
        coeffs = [tuple(wires[w] for w in self.wires_coeff(i))
                  for i in range(n)]
        constraints = []

        powers_shift = [wires[self.powers_shift(i)] for i in range(1, n)]
        shift = powers_shift[0]
        for i in range(1, n - 1):
            constraints.append(
                alg.sub(alg.mul(powers_shift[i - 1], shift), powers_shift[i]))
        powers_shift.insert(0, alg.const(1))

        # altered(w^i) = original(shift * w^i): altered_coeffs[i]=c_i*shift^i
        altered = [ext_scalar_mul(alg, c, p)
                   for c, p in zip(coeffs, powers_shift)]
        for i, g_i in enumerate(self._subgroup()):
            acc = ext_zero(alg)
            for c in reversed(altered):
                acc = ext_add(alg, ext_scalar_mul_const(alg, acc, g_i), c)
            value = tuple(wires[w] for w in self.wires_value(i))
            constraints.extend(ext_sub(alg, value, acc))

        ep_powers = [tuple(wires[w] for w in self.powers_evaluation_point(i))
                     for i in range(1, n)]
        ep = ep_powers[0]
        for i in range(1, n - 1):
            constraints.extend(
                ext_sub(alg, ext_mul(alg, ep_powers[i - 1], ep),
                        ep_powers[i]))
        # eval_with_powers: coeffs[0] + sum_i coeffs[i+1] * ep^(i+1)
        acc = coeffs[0]
        for c, p in zip(coeffs[1:], ep_powers):
            acc = ext_add(alg, acc, ext_mul(alg, c, p))
        value = tuple(wires[w] for w in self.wires_evaluation_value())
        constraints.extend(ext_sub(alg, value, acc))
        return constraints

    def generators(self, row, local_constants):
        return [_InterpolationGenerator(row, self, low_degree=True)]


class _InterpolationGenerator(SimpleGenerator):
    """Fills coeffs (+ LowDegree power wires) + evaluation value from the
    shift, values and evaluation point (reference: InterpolationGenerator in
    both gate files)."""

    def __init__(self, row, gate: _InterpolationBase, low_degree=False):
        self.row, self.gate, self.low_degree = row, gate, low_degree

    def dependencies(self):
        g = self.gate
        deps = [wire(self.row, g.wire_shift())]
        for i in range(g.num_points()):
            deps += [wire(self.row, w) for w in g.wires_value(i)]
        deps += [wire(self.row, w) for w in g.wires_evaluation_point()]
        return deps

    def run_once(self, witness, out):
        g = self.gate
        row = self.row
        n = g.num_points()
        shift = witness.get(wire(row, g.wire_shift()))
        values = [tuple(witness.get(wire(row, w)) for w in g.wires_value(i))
                  for i in range(n)]
        ep = tuple(witness.get(wire(row, w))
                   for w in g.wires_evaluation_point())

        # interpolate: q = IDFT(values) over the plain subgroup, then
        # c_j = q_j * shift^{-j} so that p(shift * g^i) = v_i
        w_root = ref.primitive_root_of_unity(g.subgroup_bits)
        n_inv = ref.inverse(n)
        shift_inv = ref.inverse(shift) if shift else 0
        coeffs = []
        for j in range(n):
            acc = (0, 0)
            for i, v in enumerate(values):
                wij = ref.exp(w_root, (-(i * j)) % n if (i * j) % n else 0)
                acc = ref.ext2_add(acc, ref.ext2_scalar_mul(v, wij))
            qj = ref.ext2_scalar_mul(acc, n_inv)
            cj = ref.ext2_scalar_mul(qj, ref.exp(shift_inv, j))
            coeffs.append(cj)

        for j in range(n):
            for w, v in zip(g.wires_coeff(j), coeffs[j]):
                out.append((wire(row, w), v))

        # evaluation value by ext Horner
        acc = (0, 0)
        for c in reversed(coeffs):
            acc = ref.ext2_add(ref.ext2_mul(acc, ep), c)
        for w, v in zip(g.wires_evaluation_value(), acc):
            out.append((wire(row, w), v))

        if self.low_degree:
            p = shift
            for i in range(2, n):
                p = ref.mul(p, shift)
                out.append((wire(row, g.powers_shift(i)), p))
            pp = ep
            for i in range(2, n):
                pp = ref.ext2_mul(pp, ep)
                for w, v in zip(g.powers_evaluation_point(i), pp):
                    out.append((wire(row, w), v))
