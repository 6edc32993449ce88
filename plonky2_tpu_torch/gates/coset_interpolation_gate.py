"""CosetInterpolationGate — interpolate values over a coset of a two-adic
subgroup and evaluate at an extension point, with degree-bounded intermediate
wires (reference: plonky2/src/gates/coset_interpolation.rs:30-330,
partial_interpolate:553-580).

Used by the recursive FRI verifier to check arity-folds. The interpolant over
coset shift*H is evaluated as P'(z * shift^-1) with P' over H, so the domain
points and barycentric weights are compile-time constants.
"""

from __future__ import annotations

from functools import lru_cache

from ..field import reference as ref
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from .ext_algebra import (
    ext_add, ext_mul, ext_scalar_mul, ext_scalar_mul_const, ext_sub,
    ext_sub_base, ext_zero,
)
from .gate import Gate

D = 2


@lru_cache(maxsize=None)
def _barycentric_weights(subgroup_bits: int) -> tuple:
    """w_i = 1 / prod_{j != i} (x_i - x_j) over the two-adic subgroup."""
    xs = ref.two_adic_subgroup(subgroup_bits)
    n = len(xs)
    ws = []
    for i in range(n):
        p = 1
        for j in range(n):
            if j != i:
                p = ref.mul(p, ref.sub(xs[i], xs[j]))
        ws.append(ref.inverse(p))
    return tuple(ws)


class CosetInterpolationGate(Gate):
    def __init__(self, subgroup_bits: int, max_degree: int):
        assert max_degree > 1
        self.subgroup_bits = subgroup_bits
        n_points = 1 << subgroup_bits
        n_intermediates = (n_points - 2) // (max_degree - 1)
        self._degree = (n_points - 2) // (n_intermediates + 1) + 2

    @classmethod
    def with_degree(cls, subgroup_bits: int, degree: int):
        """The gate of a given id's degree (`convert.gate_from_id`)."""
        gate = cls.__new__(cls)
        gate.subgroup_bits, gate._degree = subgroup_bits, degree
        return gate

    def id(self):
        return (f"CosetInterpolationGate {{ subgroup_bits: "
                f"{self.subgroup_bits}, degree: {self._degree}, "
                f"barycentric_weights: derived, _phantom: PhantomData<plonky2_field::goldilocks_field::GoldilocksField> }}")

    def num_points(self):
        return 1 << self.subgroup_bits

    def wire_shift(self):
        return 0

    def wires_value(self, i):
        s = 1 + i * D
        return range(s, s + D)

    def _start_evaluation_point(self):
        return 1 + self.num_points() * D

    def wires_evaluation_point(self):
        s = self._start_evaluation_point()
        return range(s, s + D)

    def wires_evaluation_value(self):
        s = self._start_evaluation_point() + D
        return range(s, s + D)

    def _start_intermediates(self):
        return self._start_evaluation_point() + 2 * D

    def num_intermediates(self):
        return (self.num_points() - 2) // (self._degree - 1)

    def wires_intermediate_eval(self, i):
        s = self._start_intermediates() + D * i
        return range(s, s + D)

    def wires_intermediate_prod(self, i):
        s = self._start_intermediates() + D * (self.num_intermediates() + i)
        return range(s, s + D)

    def wires_shifted_evaluation_point(self):
        s = self._start_intermediates() + 2 * D * self.num_intermediates()
        return range(s, s + D)

    def num_routed_wires(self):
        return self._start_intermediates()

    def num_wires(self):
        return self.wires_shifted_evaluation_point().stop

    def degree(self):
        return self._degree

    def num_constraints(self):
        return D * (2 + 2 * self.num_intermediates())

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        get = lambda rng: tuple(wires[w] for w in rng)
        shift = wires[self.wire_shift()]
        ep = get(self.wires_evaluation_point())
        sep = get(self.wires_shifted_evaluation_point())
        out = list(ext_sub(alg, ep, ext_scalar_mul(alg, sep, shift)))

        domain = ref.two_adic_subgroup(self.subgroup_bits)
        weights = _barycentric_weights(self.subgroup_bits)
        values = [get(self.wires_value(i)) for i in range(self.num_points())]

        def partial(dom, vals, wts, eval_acc, prod_acc):
            for x_i, v, w_i in zip(dom, vals, wts):
                term = ext_sub_base(alg, sep, x_i)
                wv = ext_scalar_mul_const(alg, v, w_i)
                eval_acc = ext_add(alg, ext_mul(alg, eval_acc, term),
                                   ext_mul(alg, wv, prod_acc))
                prod_acc = ext_mul(alg, prod_acc, term)
            return eval_acc, prod_acc

        deg = self._degree
        ev, pr = partial(domain[:deg], values[:deg], weights[:deg],
                         ext_zero(alg), (alg.const(1), alg.zero()))
        for i in range(self.num_intermediates()):
            iev = get(self.wires_intermediate_eval(i))
            ipr = get(self.wires_intermediate_prod(i))
            out.extend(ext_sub(alg, iev, ev))
            out.extend(ext_sub(alg, ipr, pr))
            start = 1 + (deg - 1) * (i + 1)
            end = min(start + deg - 1, self.num_points())
            ev, pr = partial(domain[start:end], values[start:end],
                             weights[start:end], iev, ipr)
        evaluation_value = get(self.wires_evaluation_value())
        out.extend(ext_sub(alg, evaluation_value, ev))
        return out

    def generators(self, row, local_constants):
        return [_InterpolationGenerator(row, self)]


class _InterpolationGenerator(SimpleGenerator):
    def __init__(self, row, gate: CosetInterpolationGate):
        self.row, self.gate = row, gate

    def dependencies(self):
        g = self.gate
        deps = [wire(self.row, g.wire_shift())]
        for i in range(g.num_points()):
            deps += [wire(self.row, w) for w in g.wires_value(i)]
        deps += [wire(self.row, w) for w in g.wires_evaluation_point()]
        return deps

    def run_once(self, witness, out):
        g = self.gate
        get = lambda rng: tuple(witness.get(wire(self.row, w)) for w in rng)
        shift = witness.get(wire(self.row, g.wire_shift()))
        ep = get(g.wires_evaluation_point())
        sep = ref.ext2_scalar_mul(ep, ref.inverse(shift))
        for w, v in zip(g.wires_shifted_evaluation_point(), sep):
            out.append((wire(self.row, w), v))

        domain = ref.two_adic_subgroup(g.subgroup_bits)
        weights = _barycentric_weights(g.subgroup_bits)
        values = [get(g.wires_value(i)) for i in range(g.num_points())]

        def partial(dom, vals, wts, ev, pr):
            for x_i, v, w_i in zip(dom, vals, wts):
                term = ref.ext2_sub(sep, (x_i, 0))
                wv = ref.ext2_scalar_mul(v, w_i)
                ev = ref.ext2_add(ref.ext2_mul(ev, term),
                                  ref.ext2_mul(wv, pr))
                pr = ref.ext2_mul(pr, term)
            return ev, pr

        deg = g._degree
        ev, pr = partial(domain[:deg], values[:deg], weights[:deg],
                         (0, 0), (1, 0))
        for i in range(g.num_intermediates()):
            for w, v in zip(g.wires_intermediate_eval(i), ev):
                out.append((wire(self.row, w), v))
            for w, v in zip(g.wires_intermediate_prod(i), pr):
                out.append((wire(self.row, w), v))
            start = 1 + (deg - 1) * (i + 1)
            end = min(start + deg - 1, g.num_points())
            ev, pr = partial(domain[start:end], values[start:end],
                             weights[start:end], ev, pr)
        for w, v in zip(g.wires_evaluation_value(), ev):
            out.append((wire(self.row, w), v))
