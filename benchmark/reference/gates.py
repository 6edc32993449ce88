"""The constraints of the gates a recursive verifier circuit uses, on python
ints over the extension, written from plonky2's gates/*.rs (base_sum.rs,
arithmetic_base.rs, arithmetic_extension.rs, multiplication_extension.rs,
reducing.rs, reducing_extension.rs, random_access.rs,
coset_interpolation.rs) and plonky2_field's interpolation.rs
(barycentric_weights).

Each constraint function takes (constants, wires, public-input hash), all
extension pairs, as `plonk.Gate` wants. A gate that works on extension
elements held in D = 2 wires evaluates them in plonky2's ExtensionAlgebra:
a pair (a0, a1) of extension elements, meaning a0 + a1 Y with Y^2 = 7; its
constraints are the two parts of each difference.

`from_id` makes the gate of one of plonky2's Debug-format gate ids.
"""

from __future__ import annotations

from .field import P, W, ZERO, ONE, e_add, e_mul, e_scale, e_sub, \
    root_of_unity
from .plonk import Gate

D = 2


# ExtensionAlgebra over the extension: pairs of extension pairs

def a_add(a, b):
    return (e_add(a[0], b[0]), e_add(a[1], b[1]))


def a_sub(a, b):
    return (e_sub(a[0], b[0]), e_sub(a[1], b[1]))


def a_mul(a, b):
    return (e_add(e_mul(a[0], b[0]), e_scale(e_mul(a[1], b[1]), W)),
            e_add(e_mul(a[0], b[1]), e_mul(a[1], b[0])))


def a_scale(a, s):
    """a times the extension element s."""
    return (e_mul(a[0], s), e_mul(a[1], s))


def _alg(w, start: int):
    return (w[start], w[start + 1])


# the gates, each with its wires as plonky2 lays them out

def base_sum(num_limbs: int, base: int) -> Gate:
    """Wire 0 is the sum, wires 1.. the limbs, least significant first:
    the limbs recombine to the sum, and each is one of 0 .. base - 1."""
    def constraints(c, w, h):
        limbs = w[1:1 + num_limbs]
        acc = ZERO
        for limb in reversed(limbs):
            acc = e_add(e_scale(acc, base), limb)
        out = [e_sub(acc, w[0])]
        for limb in limbs:
            prod = ONE
            for i in range(base):
                prod = e_mul(prod, e_sub(limb, (i, 0)))
            out.append(prod)
        return out
    return Gate(f"BaseSumGate {{ num_limbs: {num_limbs} }} + Base: {base}",
                base, 1 + num_limbs, constraints)


def arithmetic(num_ops: int) -> Gate:
    """Op i on wires 4i .. 4i + 3 (multiplicands, addend, output):
    output = c0 m0 m1 + c1 addend."""
    def constraints(c, w, h):
        out = []
        for i in range(num_ops):
            m0, m1, addend, output = w[4 * i:4 * i + 4]
            computed = e_add(e_mul(e_mul(m0, m1), c[0]), e_mul(addend, c[1]))
            out.append(e_sub(output, computed))
        return out
    return Gate(f"ArithmeticGate {{ num_ops: {num_ops} }}", 3, num_ops,
                constraints)


def arithmetic_extension(num_ops: int) -> Gate:
    """arithmetic() over the algebra: op i on wires 8i .. 8i + 7."""
    def constraints(c, w, h):
        out = []
        for i in range(num_ops):
            m0, m1, addend, output = (_alg(w, 4 * D * i + D * k)
                                      for k in range(4))
            computed = a_add(a_scale(a_mul(m0, m1), c[0]),
                             a_scale(addend, c[1]))
            out.extend(a_sub(output, computed))
        return out
    return Gate(f"ArithmeticExtensionGate {{ num_ops: {num_ops} }}", 3,
                D * num_ops, constraints)


def mul_extension(num_ops: int) -> Gate:
    """Op i on wires 6i .. 6i + 5 (multiplicands, output): output =
    c0 m0 m1 over the algebra."""
    def constraints(c, w, h):
        out = []
        for i in range(num_ops):
            m0, m1, output = (_alg(w, 3 * D * i + D * k) for k in range(3))
            out.extend(a_sub(output, a_scale(a_mul(m0, m1), c[0])))
        return out
    return Gate(f"MulExtensionGate {{ num_ops: {num_ops} }}", 3,
                D * num_ops, constraints)


def _reducing(num_coeffs: int, coeff_wires: int, name: str) -> Gate:
    """Output at wires 0-1, alpha 2-3, the old accumulator 4-5, then the
    coefficients (`coeff_wires` wires each), then the accumulators after
    each coefficient but the last, whose accumulator is the output:
    acc_i = acc_{i-1} alpha + coeff_i over the algebra."""
    start_accs = 3 * D + num_coeffs * coeff_wires

    def constraints(c, w, h):
        alpha, acc = _alg(w, D), _alg(w, 2 * D)
        out = []
        for i in range(num_coeffs):
            at = 3 * D + i * coeff_wires
            coeff = (_alg(w, at) if coeff_wires == D else (w[at], ZERO))
            nxt = _alg(w, 0 if i == num_coeffs - 1 else start_accs + D * i)
            out.extend(a_sub(a_add(a_mul(acc, alpha), coeff), nxt))
            acc = nxt
        return out
    return Gate(f"{name} {{ num_coeffs: {num_coeffs} }}", 2, D * num_coeffs,
                constraints)


def reducing(num_coeffs: int) -> Gate:
    """Coefficients in the base field, one wire each."""
    return _reducing(num_coeffs, 1, "ReducingGate")


def reducing_extension(num_coeffs: int) -> Gate:
    """Coefficients in the extension, two wires each."""
    return _reducing(num_coeffs, D, "ReducingExtensionGate")


PHANTOM = ("_phantom: PhantomData<plonky2_field::goldilocks_field::"
           "GoldilocksField> }")


def random_access(bits: int, num_copies: int,
                  num_extra_constants: int) -> Gate:
    """Copy k on wires (2 + 2^bits) k ..: the access index, the claimed
    element, the list; after every copy, the extra constants' wires; after
    the routed wires, each copy's bits of the index. The bits are boolean
    and recombine to the index, and folding the list by them, lowest bit
    first, leaves the claimed element; each extra constant's wire holds
    its constant."""
    size = 1 << bits
    routed = (2 + size) * num_copies + num_extra_constants

    def constraints(c, w, h):
        out = []
        for k in range(num_copies):
            base = (2 + size) * k
            index, claimed = w[base], w[base + 1]
            items = w[base + 2:base + 2 + size]
            bit_wires = w[routed + k * bits:routed + (k + 1) * bits]
            out.extend(e_mul(b, e_sub(b, ONE)) for b in bit_wires)
            acc = ZERO
            for b in reversed(bit_wires):
                acc = e_add(e_add(acc, acc), b)
            out.append(e_sub(acc, index))
            for b in bit_wires:
                items = [e_add(x, e_mul(b, e_sub(y, x)))
                         for x, y in zip(items[0::2], items[1::2])]
            out.append(e_sub(items[0], claimed))
        start = (2 + size) * num_copies
        out.extend(e_sub(c[i], w[start + i])
                   for i in range(num_extra_constants))
        return out
    return Gate(f"RandomAccessGate {{ bits: {bits}, num_copies: "
                f"{num_copies}, num_extra_constants: "
                f"{num_extra_constants}, {PHANTOM}", bits + 1,
                num_copies * (bits + 2) + num_extra_constants, constraints)


def barycentric_weights(xs: list[int]) -> list[int]:
    """1 / prod_{j != i} (x_i - x_j) for each point x_i."""
    out = []
    for i, x in enumerate(xs):
        prod = 1
        for j, y in enumerate(xs):
            if j != i:
                prod = prod * (x - y) % P
        out.append(pow(prod, P - 2, P))
    return out


def coset_interpolation(subgroup_bits: int, degree: int) -> Gate:
    """Wire 0 the coset's shift, then the 2^subgroup_bits values (two wires
    each), the evaluation point, the evaluation value, the intermediate
    evaluations, the intermediate products and the shifted evaluation
    point. The shifted point times the shift is the point, and the
    barycentric sum of the values over the subgroup at the shifted point,
    taken degree - 1 points at a time through the intermediates, is the
    evaluation value."""
    n = 1 << subgroup_bits
    num_inter = (n - 2) // (degree - 1)
    g = root_of_unity(subgroup_bits)
    domain = [pow(g, i, P) for i in range(n)]
    weights = barycentric_weights(domain)
    start_point = 1 + n * D
    start_inter = start_point + 2 * D
    shifted_at = start_inter + 2 * D * num_inter

    def partial(lo, hi, values, point, ev, prod):
        for i in range(lo, hi):
            term = a_sub(point, ((domain[i], 0), ZERO))
            ev = a_add(a_mul(ev, term),
                       a_mul(a_scale(values[i], (weights[i], 0)), prod))
            prod = a_mul(prod, term)
        return ev, prod

    def constraints(c, w, h):
        shift = w[0]
        point = _alg(w, start_point)
        shifted = _alg(w, shifted_at)
        out = list(a_sub(point, a_scale(shifted, shift)))
        values = [_alg(w, 1 + D * i) for i in range(n)]
        ev, prod = partial(0, degree, values, shifted, (ZERO, ZERO),
                           (ONE, ZERO))
        for i in range(num_inter):
            iev = _alg(w, start_inter + D * i)
            iprod = _alg(w, start_inter + D * (num_inter + i))
            out.extend(a_sub(iev, ev))
            out.extend(a_sub(iprod, prod))
            lo = 1 + (degree - 1) * (i + 1)
            ev, prod = partial(lo, min(lo + degree - 1, n), values, shifted,
                               iev, iprod)
        out.extend(a_sub(_alg(w, start_point + D), ev))
        return out
    return Gate(f"CosetInterpolationGate {{ subgroup_bits: {subgroup_bits}, "
                f"degree: {degree}, barycentric_weights: derived, {PHANTOM}",
                degree, D * (2 + 2 * num_inter), constraints)


def fields(gate_id: str) -> dict:
    """The whole-number fields of a Debug-format id: "BaseSumGate {
    num_limbs: 4 } + Base: 2" -> {"num_limbs": 4, "Base": 2}."""
    out = {}
    for part in gate_id.replace("{", ",").replace("}", ",").replace(
            "+", ",").split(","):
        key, sep, value = part.partition(":")
        if sep and value.strip().isdigit():
            out[key.strip()] = int(value)
    return out


KINDS = {
    "BaseSumGate": lambda f: base_sum(f["num_limbs"], f["Base"]),
    "ArithmeticGate": lambda f: arithmetic(f["num_ops"]),
    "ArithmeticExtensionGate": lambda f: arithmetic_extension(f["num_ops"]),
    "MulExtensionGate": lambda f: mul_extension(f["num_ops"]),
    "ReducingGate": lambda f: reducing(f["num_coeffs"]),
    "ReducingExtensionGate": lambda f: reducing_extension(f["num_coeffs"]),
    "RandomAccessGate": lambda f: random_access(
        f["bits"], f["num_copies"], f["num_extra_constants"]),
    "CosetInterpolationGate": lambda f: coset_interpolation(
        f["subgroup_bits"], f["degree"]),
}


def from_id(gate_id: str) -> Gate:
    """The gate of `gate_id`, whose id it reproduces exactly; raises
    ValueError on a kind or a form this module does not know."""
    kind = gate_id.split(" ")[0]
    if kind not in KINDS:
        raise ValueError(f"no constraint code for {gate_id!r}")
    try:
        gate = KINDS[kind](fields(gate_id))
    except KeyError as e:
        raise ValueError(f"{gate_id!r} lacks the field {e}") from None
    if gate.id != gate_id:
        raise ValueError(f"{gate_id!r} is not the id of {gate.id!r}")
    return gate
