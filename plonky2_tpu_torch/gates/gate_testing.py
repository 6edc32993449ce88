"""Gate degree-audit harness.

Port of the reference's `test_low_degree` (gates/gate_testing.rs:24-87):
feed every wire/constant a random degree-31 polynomial (evaluated on a
subgroup blown up past the gate's declared degree), evaluate the gate's
constraints pointwise, interpolate each constraint back to coefficients and
assert the measured degree is at most `31 * gate.degree()`. A gate that
under-declares `degree()` silently corrupts selector grouping and the
quotient decomposition — this harness is what catches it.

Runs over the host python-int base-field algebra (the constraint composition
is the same polynomial identity over the base field as over the extension the
reference uses; measuring its degree needs no extension arithmetic).
"""

from __future__ import annotations

import random

from ..field import reference as ref
from ..hash.poseidon_fast import INT

WITNESS_SIZE = 32
WITNESS_DEGREE = WITNESS_SIZE - 1


def _ntt(values: list[int], invert: bool = False) -> list[int]:
    """Iterative radix-2 NTT over Goldilocks, python ints (N <= 2^10)."""
    n = len(values)
    lg = n.bit_length() - 1
    assert 1 << lg == n
    a = list(values)
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    root = ref.primitive_root_of_unity(lg)
    if invert:
        root = ref.inverse(root)
    length = 2
    while length <= n:
        w_len = ref.exp(root, n // length)
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + length // 2):
                u = a[k]
                v = ref.mul(a[k + length // 2], w)
                a[k] = ref.add(u, v)
                a[k + length // 2] = ref.sub(u, v)
                w = ref.mul(w, w_len)
        length <<= 1
    if invert:
        n_inv = ref.inverse(n)
        a = [ref.mul(x, n_inv) for x in a]
    return a


def _random_low_degree_values(n_points: int, rng: random.Random) -> list[int]:
    """Evaluations on the size-n_points subgroup of a random degree-31 poly
    (reference: gate_testing.rs random_low_degree_values:82-87)."""
    coeffs = [rng.randrange(ref.ORDER) for _ in range(WITNESS_SIZE)]
    coeffs += [0] * (n_points - WITNESS_SIZE)
    return _ntt(coeffs)


def measured_constraint_degrees(gate, seed: int = 0) -> list[int]:
    """Evaluate the gate's constraints on random low-degree wire/constant
    polynomials and return each constraint's measured degree."""
    rng = random.Random(seed)
    rate_bits = max(1, (gate.degree()).bit_length())  # 2^rate > degree
    while (1 << rate_bits) <= gate.degree():
        rate_bits += 1
    n = WITNESS_SIZE << rate_bits

    wires = [_random_low_degree_values(n, rng)
             for _ in range(gate.num_wires())]
    consts = [_random_low_degree_values(n, rng)
              for _ in range(gate.num_constants())]
    pi_hash = [rng.randrange(ref.ORDER) for _ in range(4)]

    num_constraints = gate.num_constraints()
    per_constraint = [[0] * n for _ in range(num_constraints)]
    for i in range(n):
        local_wires = [w[i] for w in wires]
        local_consts = [c[i] for c in consts]
        evals = gate.eval_unfiltered(INT, local_consts, local_wires, pi_hash)
        assert len(evals) == num_constraints, (
            f"{gate.id()}: eval returned {len(evals)} constraints, "
            f"declared {num_constraints}")
        for j, e in enumerate(evals):
            per_constraint[j][i] = e % ref.ORDER

    degrees = []
    for vec in per_constraint:
        coeffs = _ntt(vec, invert=True)
        deg = 0
        for k in range(n - 1, -1, -1):
            if coeffs[k] % ref.ORDER:
                deg = k
                break
        degrees.append(deg)
    return degrees


def assert_low_degree(gate) -> None:
    """reference: gate_testing.rs:24-67 test_low_degree."""
    degrees = measured_constraint_degrees(gate)
    expected = WITNESS_DEGREE * gate.degree()
    too_high = [(i, d) for i, d in enumerate(degrees) if d > expected]
    assert not too_high, (
        f"{gate.id()}: constraints exceed declared degree "
        f"{gate.degree()} (allowed eval degree {expected}): {too_high}")
