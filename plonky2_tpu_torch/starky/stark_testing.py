"""STARK test harnesses.

Port of the reference's stark_testing.rs:
- `assert_stark_low_degree` (reference :25-74): random low-degree trace
  columns, evaluate the full constraint accumulator over the blown-up
  subgroup, interpolate, assert measured degree <= 32*constraint_degree - 1.
- `assert_stark_eval_coherence` (analog of test_stark_circuit_constraints
  :76-140): the reference checks the hand-written recursive (circuit)
  constraint evaluation against the native one; here all evaluation paths
  share ONE algebra-generic `eval`, so the meaningful check is coherence of
  the base-int algebra (prover path) with the extension algebra (verifier /
  recursive path) on embedded base values.
"""

from __future__ import annotations

import random

from ..field import reference as ref
from ..gates.gate import EXT
from ..gates.gate_testing import WITNESS_SIZE, _ntt
from ..hash.poseidon_fast import INT
from .stark import ConstraintConsumer, EvaluationFrame


def _low_degree_lde(values32: list[int], n: int) -> list[int]:
    """Interpolate 32 subgroup values, evaluate on the size-n supergroup."""
    coeffs = _ntt(values32, invert=True)
    return _ntt(coeffs + [0] * (n - WITNESS_SIZE))


def assert_stark_low_degree(stark, seed: int = 0) -> None:
    """reference: stark_testing.rs:25-74 test_stark_low_degree."""
    rng = random.Random(seed)
    d = stark.constraint_degree()
    rate_bits = 1
    while (1 << rate_bits) <= d:
        rate_bits += 1
    n = WITNESS_SIZE << rate_bits

    trace_ldes = []
    for _ in range(stark.COLUMNS):
        coeffs = [rng.randrange(ref.ORDER) for _ in range(WITNESS_SIZE)]
        trace_ldes.append(_ntt(coeffs + [0] * (n - WITNESS_SIZE)))
    public_inputs = [rng.randrange(ref.ORDER)
                     for _ in range(stark.PUBLIC_INPUTS)]

    sel_first = [1] + [0] * (WITNESS_SIZE - 1)
    sel_last = [0] * (WITNESS_SIZE - 1) + [1]
    lagrange_first = _low_degree_lde(sel_first, n)
    lagrange_last = _low_degree_lde(sel_last, n)

    lg32 = WITNESS_SIZE.bit_length() - 1
    last = ref.inverse(ref.primitive_root_of_unity(lg32))
    g_n = ref.primitive_root_of_unity(n.bit_length() - 1)
    alpha = rng.randrange(ref.ORDER)

    evals = []
    x = 1
    step = 1 << rate_bits
    for i in range(n):
        frame = EvaluationFrame(
            local_values=[c[i] for c in trace_ldes],
            next_values=[c[(i + step) % n] for c in trace_ldes],
            public_inputs=public_inputs)
        consumer = ConstraintConsumer(
            INT, [alpha], ref.sub(x, last),
            lagrange_first[i], lagrange_last[i])
        stark.eval(INT, frame, consumer)
        evals.append(consumer.accs[0] % ref.ORDER)
        x = ref.mul(x, g_n)

    coeffs = _ntt(evals, invert=True)
    measured = 0
    for k in range(n - 1, -1, -1):
        if coeffs[k] % ref.ORDER:
            measured = k
            break
    maximum = max(0, WITNESS_SIZE * d - 1)  # saturating_sub(1) in reference
    assert measured <= maximum, (
        f"{type(stark).__name__}: constraint degree too high — measured "
        f"{measured}, allowed {maximum} (declared degree {d})")


def assert_stark_eval_coherence(stark, seed: int = 1) -> None:
    """Base-int vs extension-algebra evaluation coherence on embedded base
    values (analog of stark_testing.rs:76-140)."""
    rng = random.Random(seed)
    local = [rng.randrange(ref.ORDER) for _ in range(stark.COLUMNS)]
    nxt = [rng.randrange(ref.ORDER) for _ in range(stark.COLUMNS)]
    pis = [rng.randrange(ref.ORDER) for _ in range(stark.PUBLIC_INPUTS)]
    alpha = rng.randrange(ref.ORDER)
    z_last = rng.randrange(ref.ORDER)
    l_first = rng.randrange(ref.ORDER)
    l_last = rng.randrange(ref.ORDER)

    c_base = ConstraintConsumer(INT, [alpha], z_last, l_first, l_last)
    stark.eval(INT, EvaluationFrame(local, nxt, pis), c_base)

    def e(x):
        return (x, 0)

    c_ext = ConstraintConsumer(EXT, [e(alpha)], e(z_last), e(l_first),
                               e(l_last))
    stark.eval(EXT, EvaluationFrame([e(x) for x in local],
                                    [e(x) for x in nxt],
                                    [e(x) for x in pis]), c_ext)
    base = c_base.accs[0] % ref.ORDER
    ext = c_ext.accs[0]
    assert (base, 0) == (ext[0] % ref.ORDER, ext[1] % ref.ORDER), (
        f"{type(stark).__name__}: base/extension evaluation mismatch")
