"""The port's gadget crates (plonky2_tpu_torch/gadgets/u32.py, ecdsa/,
ecgfp5/, gates/lookup_gates.py, gates/interpolation_gates.py and
PoseidonMdsGate) against the JAX package's, on the CPU at small sizes.

- Each new gate against its JAX gate on the same random inputs from a numpy
  seed: id and shape, `eval_unfiltered` over extension scalars and over
  base-field rows, its generators' outputs, which make every constraint
  zero; and its constraints laid out in a circuit (TargetAlgebra) against
  the extension-scalar values.
- The port's versions of the JAX package's gadget tests (test_u32.py,
  test_biguint.py, test_nonnative.py, test_ecgfp5.py,
  test_ecgfp5_gadgets.py, test_lookup.py, test_ecdsa_native.py,
  test_curve_gadgets.py's add/double circuit, test_gates.py's
  interpolation and MDS tests), with the same assertions and helpers
  (test_gates.py's `run_gate`, `assert_vanishes`); where those build
  a circuit, the port lays it out with `build_host()` and checks every row
  with the prover's own gate evaluation (`_check_all_rows`).
- The in-circuit Schnorr verification (2^12, never proved here): layout,
  CommonCircuitData, constants, sigmas and witness equal to JAX's; a
  signature with s + 1 makes no witness.
- A circuit of u32, lookup, quintic and BigUint gadgets under
  `standard_ecc_config()` (136 wires, 2^5): proved and verified by the
  port, its bytes verified by the JAX package; the same circuit built by
  JAX, carried over by `convert.py` and proved by the port.
Tolerance: exact.
"""

import random

import numpy as np
import pytest
import torch

import gadget_circuits
from test_gates import assert_vanishes, run_gate
from plonky2_tpu.ecdsa import curve as jsecp
from plonky2_tpu.ecdsa import curve_gadgets as jcurve_gadgets
from plonky2_tpu.ecgfp5 import gadgets as jgfp5
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.gadgets import u32 as ju32
from plonky2_tpu.gates import gate as jgate
from plonky2_tpu.gates import interpolation_gates as jinterp
from plonky2_tpu.gates import lookup_gates as jlookup
from plonky2_tpu.gates import misc_gates as jmg
from plonky2_tpu.iop.generator import \
    generate_partial_witness as jgenerate_partial_witness
from plonky2_tpu.iop.witness import PartialWitness as JPartialWitness
from plonky2_tpu.iop.witness import PartitionWitness as JPartitionWitness
from plonky2_tpu.plonk import verifier as jverifier
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.convert import (
    circuit_data_from_arrays, common_from, generator_from,
)
from plonky2_tpu_torch.ecdsa import curve as secp
from plonky2_tpu_torch.ecdsa import curve_gadgets
from plonky2_tpu_torch.ecdsa.biguint import (
    get_biguint_target, set_biguint_target,
)
from plonky2_tpu_torch.ecdsa.nonnative import (
    get_nonnative_target, set_nonnative_target,
)
from plonky2_tpu_torch.ecgfp5 import curve as ec
from plonky2_tpu_torch.ecgfp5 import gadgets as gfp5
from plonky2_tpu_torch.ecgfp5.scalar_field import Scalar
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field import reference as ref
from plonky2_tpu_torch.gadgets import u32
from plonky2_tpu_torch.gates import gate
from plonky2_tpu_torch.gates import interpolation_gates as interp
from plonky2_tpu_torch.gates import lookup_gates as lookup
from plonky2_tpu_torch.gates import misc_gates as mg
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.target import wire
from plonky2_tpu_torch.iop.witness import PartialWitness, PartitionWitness
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.vanishing import evaluate_gate_constraints_rows
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis

ORDER = ref.ORDER
PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
ECC = CircuitConfig.standard_ecc_config()
JECC = JCircuitConfig.standard_ecc_config()
LUT = tuple((i, (i * i + 7) % 256) for i in range(16))

# name -> (the port's gate, the JAX package's gate), at the variants the
# Schnorr and secp256k1-curve circuits lay out
GATES = {
    "u32_arithmetic": (u32.U32ArithmeticGate.from_config(ECC),
                       ju32.U32ArithmeticGate.from_config(JECC)),
    "u32_add_many_2": (u32.U32AddManyGate.from_config(ECC, 2),
                       ju32.U32AddManyGate.from_config(JECC, 2)),
    "u32_add_many_15": (u32.U32AddManyGate.from_config(ECC, 15),
                        ju32.U32AddManyGate.from_config(JECC, 15)),
    "u32_subtraction": (u32.U32SubtractionGate.from_config(ECC),
                        ju32.U32SubtractionGate.from_config(JECC)),
    "comparison": (u32.ComparisonGate(32, 16), ju32.ComparisonGate(32, 16)),
    "u32_range_check": (u32.U32RangeCheckGate(8), ju32.U32RangeCheckGate(8)),
    "mul_gfp5": (gfp5.MulGFp5Gate.from_config(ECC),
                 jgfp5.MulGFp5Gate.from_config(JECC)),
    "lookup": (lookup.LookupGate.from_config(ECC, LUT),
               jlookup.LookupGate.from_config(JECC, LUT)),
    "lookup_table": (lookup.LookupTableGate(26, LUT, 0),
                     jlookup.LookupTableGate(26, LUT, 0)),
    "high_degree_interpolation": (interp.HighDegreeInterpolationGate(2),
                                  jinterp.HighDegreeInterpolationGate(2)),
    "low_degree_interpolation": (interp.LowDegreeInterpolationGate(2),
                                 jinterp.LowDegreeInterpolationGate(2)),
    "poseidon_mds": (mg.PoseidonMdsGate(), jmg.PoseidonMdsGate()),
}
NAMES = list(GATES)
# LookupTableGate has no generator (the logUp argument is disabled)
GENERATED = [n for n in NAMES if n != "lookup_table"]


def _rng(name, salt):
    return np.random.default_rng([NAMES.index(name), salt])


def _rand(rng, *shape):
    return rng.integers(0, ORDER, size=shape, dtype=np.uint64)


def test_gate_ids_are_the_circuits():
    """The variants above are those the Schnorr (standard_recursion_config)
    and secp256k1-curve (standard_ecc_config) circuits lay out."""
    ids = {n: GATES[n][0].id() for n in NAMES}
    assert ids["u32_arithmetic"] == "U32ArithmeticGate { num_ops: 3 }"
    assert ids["u32_add_many_2"] == \
        "U32AddManyGate { num_addends: 2, num_ops: 5 }"
    assert ids["u32_add_many_15"] == \
        "U32AddManyGate { num_addends: 15, num_ops: 3 }"
    assert ids["u32_subtraction"] == "U32SubtractionGate { num_ops: 6 }"
    assert ids["mul_gfp5"] == "MulGFp5Gate { num_ops: 5 }"
    assert ids["lookup"].startswith("LookupGate { num_slots: 40, lut: ")
    rec = CircuitConfig.standard_recursion_config()
    assert u32.U32ArithmeticGate.from_config(rec).id() == \
        ids["u32_arithmetic"]
    assert gfp5.MulGFp5Gate.from_config(rec).id() == ids["mul_gfp5"]


@pytest.mark.parametrize("name", NAMES)
def test_gate_shape_matches_jax(name):
    g, j = GATES[name]
    assert g.id() == j.id()
    for attr in ("num_wires", "num_constants", "degree", "num_constraints",
                 "num_ops", "extra_constant_wires"):
        assert getattr(g, attr)() == getattr(j, attr)(), attr
    assert g.num_wires() <= ECC.num_wires


@pytest.mark.parametrize("name", NAMES)
def test_eval_unfiltered_ext_matches_jax(name):
    """Over extension scalars (the verifier at zeta), random wires."""
    g, j = GATES[name]
    rng = _rng(name, 0)
    pairs = lambda n: [tuple(int(v) for v in p) for p in _rand(rng, n, 2)]
    wires, consts, pi = pairs(g.num_wires()), pairs(2), pairs(4)
    got = g.eval_unfiltered(gate.EXT, consts, wires, pi)
    assert len(got) == g.num_constraints()
    assert got == j.eval_unfiltered(jgate.EXT, consts, wires, pi)


@pytest.mark.parametrize("name", NAMES)
def test_eval_unfiltered_rows_matches_jax(name):
    """Over base-field rows [num_wires, 32] (the prover's round 3)."""
    g, j = GATES[name]
    rng = _rng(name, 1)
    wires, consts, pi = (_rand(rng, g.num_wires(), 32), _rand(rng, 2, 32),
                         _rand(rng, 4, 32))
    got = g.eval_unfiltered_rows(*(gl.from_u64(x, "cpu")
                                   for x in (consts, wires, pi)))
    want = j.eval_unfiltered_rows(*(GF.from_u64(x)
                                    for x in (consts, wires, pi)))
    assert got.shape == (g.num_constraints(), 32)
    np.testing.assert_array_equal(gl.to_u64(got), want.to_u64())


@pytest.mark.parametrize("name", NAMES)
def test_eval_unfiltered_in_circuit_matches_ext(name):
    """The same constraint code over TargetAlgebra (what a recursive wrap
    of these proofs would lay out): the witness of the circuit it builds
    holds the extension-scalar values on the same random inputs."""
    from plonky2_tpu_torch.gates.target_algebra import TargetAlgebra
    g, _ = GATES[name]
    rng = _rng(name, 3)
    pairs = lambda n: [tuple(int(v) for v in p) for p in _rand(rng, n, 2)]
    values = [pairs(2), pairs(g.num_wires()), pairs(4)]  # consts, wires, pi
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    targets = [builder.add_virtual_extension_targets(len(v)) for v in values]
    out = g.eval_unfiltered(TargetAlgebra(builder), *targets)
    pw = PartialWitness()
    for ts, vs in zip(targets, values):
        for t, v in zip(ts, vs):
            pw.set_target(t[0], v[0])
            pw.set_target(t[1], v[1])
    _, witness = _witness(builder, pw)
    assert [(witness.get(t[0]), witness.get(t[1])) for t in out] == \
        g.eval_unfiltered(gate.EXT, *values)


def _bounds(name, g) -> dict:
    """Wire -> exclusive bound of the inputs the gate's generators take in
    range (u32 values, carries and borrows, table inputs)."""
    b = {}
    if name == "u32_arithmetic":
        for i in range(g.num_ops()):
            for w in (g.wire_multiplicand_0(i), g.wire_multiplicand_1(i),
                      g.wire_addend(i)):
                b[w] = 1 << 32
    elif name.startswith("u32_add_many"):
        for i in range(g.num_ops()):
            b.update({g.wire_addend(i, j): 1 << 32
                      for j in range(g.num_addends)})
            b[g.wire_carry(i)] = 1 << 4
    elif name == "u32_subtraction":
        for i in range(g.num_ops()):
            b.update({g.wire_input_x(i): 1 << 32, g.wire_input_y(i): 1 << 32,
                      g.wire_input_borrow(i): 2})
    elif name == "comparison":
        b = {g.wire_first_input(): 1 << 32, g.wire_second_input(): 1 << 32}
    elif name == "u32_range_check":
        b = {g.wire_ith_input_limb(i): 1 << 32
             for i in range(g.num_input_limbs)}
    elif name == "lookup":
        b = {g.wire_ith_looking_inp(i): len(LUT) for i in range(g.num_ops())}
    return b


def _run(generators, witness):
    out = []
    for gen in generators:
        buf = []
        assert gen.run(witness, buf)
        for t, v in buf:
            witness.set(t, v)
        out += [(tuple(t), int(v)) for t, v in buf]
    return out


@pytest.mark.parametrize("name", GENERATED)
def test_generators_match_jax_and_satisfy_the_gate(name):
    """On the same partial witness the port's generators write what JAX's
    write; with their outputs every constraint is zero."""
    g, j = GATES[name]
    rng = _rng(name, 2)
    consts = [int(v) for v in _rand(rng, g.num_constants())]
    bounds = _bounds(name, g)
    deps = {t[2]: int(rng.integers(0, bounds.get(t[2], ORDER),
                                   dtype=np.uint64))
            for gen in g.generators(0, consts) for t in gen.dependencies()}
    rep = np.arange(ECC.num_wires, dtype=np.int64)
    witness = PartitionWitness(rep, ECC.num_wires, 1)
    jwitness = JPartitionWitness(rep, ECC.num_wires, 1)
    for w, v in deps.items():
        witness.set(wire(0, w), v)
        jwitness.set(wire(0, w), v)
    got = _run(g.generators(0, consts), witness)
    want = _run(j.generators(0, consts), jwitness)
    assert got == want and got
    assert witness.as_list() == jwitness.values
    row = [(v or 0, 0) for v in witness.as_list()[:g.num_wires()]]
    assert g.eval_unfiltered(gate.EXT, [(c, 0) for c in consts], row,
                             [(0, 0)] * 4) == [(0, 0)] * g.num_constraints()


# ---------------------------------------------------------------------------
# The JAX package's gadget tests, on the port
# ---------------------------------------------------------------------------

def _check_all_rows(host, witness):
    """Every row's own gate constraints vanish: the prover's filtered gate
    evaluation (`evaluate_gate_constraints_rows`) over the subgroup, where
    a row's selectors pick its gate, is zero everywhere."""
    common = host.common
    pis = [witness.get(t) for t in host.public_inputs]
    pi_hash = common.gc.hash_public_inputs(pis)
    n = common.degree
    out = evaluate_gate_constraints_rows(
        common,
        gl.from_u64(host.constants_sigmas[:common.num_constants], "cpu"),
        gl.from_u64(witness.full_witness(), "cpu"),
        gl.from_u64(np.tile(np.asarray(pi_hash, dtype=np.uint64)[:, None],
                            (1, n)), "cpu"))
    bad = torch.nonzero(out.ne(0).any(0)).reshape(-1).tolist()
    assert not bad, f"rows with nonzero constraints: {bad[:10]}"


def _witness(builder, pw):
    host = builder.build_host()
    return host, generate_partial_witness(pw, host, host.common)


def test_u32_arithmetic_add_many_subtraction_gates():
    """test_u32.py's three gate tests."""
    rng = random.Random(21)
    g = u32.U32ArithmeticGate.from_config(CircuitConfig())
    ins = {}
    for i in range(g.num_ops()):
        for w in (g.wire_multiplicand_0(i), g.wire_multiplicand_1(i),
                  g.wire_addend(i)):
            ins[w] = rng.randrange(1 << 32)
    wires = run_gate(g, ins)
    assert_vanishes(g, wires)
    x, y, z = (ins[g.wire_multiplicand_0(0)], ins[g.wire_multiplicand_1(0)],
               ins[g.wire_addend(0)])
    assert (wires[g.wire_output_high(0)] << 32) | \
        wires[g.wire_output_low(0)] == x * y + z

    g = u32.U32AddManyGate.from_config(CircuitConfig(), 11)
    ins = {}
    for i in range(g.num_ops()):
        for j in range(11):
            ins[g.wire_addend(i, j)] = rng.randrange(1 << 32)
        ins[g.wire_carry(i)] = rng.randrange(4)
    assert_vanishes(g, run_gate(g, ins))

    g = u32.U32SubtractionGate.from_config(CircuitConfig())
    ins = {}
    for i in range(g.num_ops()):
        ins[g.wire_input_x(i)] = rng.randrange(1 << 32)
        ins[g.wire_input_y(i)] = rng.randrange(1 << 32)
        ins[g.wire_input_borrow(i)] = rng.randrange(2)
    wires = run_gate(g, ins)
    assert_vanishes(g, wires)
    x, y, b = (ins[g.wire_input_x(0)], ins[g.wire_input_y(0)],
               ins[g.wire_input_borrow(0)])
    assert wires[g.wire_output_result(0)] - \
        (wires[g.wire_output_borrow(0)] << 32) == x - y - b


def test_comparison_and_range_check_gates():
    """test_u32.py's comparison and range-check tests: an input of 2^32
    violates a range-check constraint."""
    rng = random.Random(22)
    g = u32.ComparisonGate(32, 16)
    for a, b in [(0, 0), (5, 5), (3, 9), (9, 3),
                 (rng.randrange(1 << 32), rng.randrange(1 << 32)),
                 ((1 << 32) - 1, 0), (0, (1 << 32) - 1)]:
        wires = run_gate(g, {g.wire_first_input(): a,
                              g.wire_second_input(): b})
        assert_vanishes(g, wires)
        assert wires[g.wire_result_bool()] == (1 if a <= b else 0)
    g = u32.U32RangeCheckGate(4)
    assert_vanishes(g, run_gate(g, {g.wire_ith_input_limb(i):
                                      rng.randrange(1 << 32)
                                      for i in range(4)}))
    g = u32.U32RangeCheckGate(1)
    with pytest.raises(AssertionError):
        assert_vanishes(g, run_gate(g, {g.wire_ith_input_limb(0): 1 << 32}))


def test_u32_gadget_circuit_witness():
    """test_u32.py's circuit: mul_add, add_many and sub of u32 targets."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    lo, hi = builder.mul_add_u32(a, b, builder.constant_u32(77))
    s, _ = builder.add_many_u32([lo, hi, builder.constant_u32(5)])
    d, _ = builder.sub_u32(s, lo)
    for t in (a, b, lo, hi, s, d):
        builder.register_public_input(t)
    pw = PartialWitness()
    av, bv = 0xDEADBEEF, 0x12345678
    pw.set_target(a, av)
    pw.set_target(b, bv)
    host, witness = _witness(builder, pw)
    pis = [witness.get(t) for t in host.public_inputs]
    val = av * bv + 77
    assert pis[2:] == [val & 0xFFFFFFFF, val >> 32,
                       (pis[2] + pis[3] + 5) & 0xFFFFFFFF,
                       (pis[4] - pis[2]) % (1 << 32)]
    _check_all_rows(host, witness)


def test_biguint_ops_witness():
    """test_biguint.py: add, sub, mul, div_rem and cmp of 256- and 192-bit
    values."""
    rng = random.Random(17)
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    a_val, b_val = rng.getrandbits(256), rng.getrandbits(192)
    a = builder.add_virtual_biguint_target(8)
    b = builder.add_virtual_biguint_target(6)
    s = builder.add_biguint(a, b)
    d = builder.sub_biguint(a, b)
    p = builder.mul_biguint(a, b)
    q, r = builder.div_rem_biguint(a, b)
    le = builder.cmp_biguint(b, a)
    pw = PartialWitness()
    set_biguint_target(pw, a, a_val)
    set_biguint_target(pw, b, b_val)
    host, witness = _witness(builder, pw)
    assert get_biguint_target(witness, s) == a_val + b_val
    assert get_biguint_target(witness, d) == a_val - b_val
    assert get_biguint_target(witness, p) == a_val * b_val
    assert get_biguint_target(witness, q) == a_val // b_val
    assert get_biguint_target(witness, r) == a_val % b_val
    assert witness.get(le) == 1
    _check_all_rows(host, witness)


def test_nonnative_ops_witness():
    """test_nonnative.py: add, sub, mul, inv and neg mod the secp256k1 base
    field under standard_ecc_config()."""
    rng = random.Random(23)
    builder = CircuitBuilder(CircuitConfig.standard_ecc_config())
    a_val, b_val = rng.randrange(secp.P), rng.randrange(1, secp.P)
    a = builder.add_virtual_nonnative_target(secp.P)
    b = builder.add_virtual_nonnative_target(secp.P)
    s = builder.add_nonnative(a, b)
    d = builder.sub_nonnative(a, b)
    p = builder.mul_nonnative(a, b)
    inv = builder.inv_nonnative(b)
    neg = builder.neg_nonnative(a)
    pw = PartialWitness()
    set_nonnative_target(pw, a, a_val)
    set_nonnative_target(pw, b, b_val)
    host, witness = _witness(builder, pw)
    assert host.common.config.num_wires == 136
    assert get_nonnative_target(witness, s) == (a_val + b_val) % secp.P
    assert get_nonnative_target(witness, d) == (a_val - b_val) % secp.P
    assert get_nonnative_target(witness, p) == (a_val * b_val) % secp.P
    assert get_nonnative_target(witness, inv) == pow(b_val, secp.P - 2,
                                                     secp.P)
    assert get_nonnative_target(witness, neg) == (-a_val) % secp.P
    _check_all_rows(host, witness)


def test_ecgfp5_curve_schnorr_and_scalars():
    """test_ecgfp5.py: the group law, Schnorr sign/verify, the scalar
    field's axioms and encodings, signed recoding, mulgen."""
    rng = random.Random(43)
    N = ec.N
    g2 = ec.GENERATOR.double()
    assert ec.GENERATOR.is_valid() and g2.is_valid()
    assert ec.GENERATOR.add(ec.GENERATOR).x == g2.x
    assert ec.GENERATOR.mul(N).is_inf
    assert ec.GENERATOR.add(ec.GENERATOR.neg()).is_inf
    a, b = rng.randrange(1, N), rng.randrange(1, N)
    lhs = ec.GENERATOR.mul((a + b) % N)
    rhs = ec.GENERATOR.mul(a).add(ec.GENERATOR.mul(b))
    assert (lhs.x, lhs.y) == (rhs.x, rhs.y)
    assert ec.NEUTRAL.add(ec.GENERATOR).x == ec.GENERATOR.x

    pk, sk = ec.schnorr_keygen(rng.randrange(1, N))
    msg = [rng.randrange(ORDER) for _ in range(6)]
    sig = ec.schnorr_sign(msg, sk, k=rng.randrange(1, N))
    assert ec.schnorr_verify(msg, pk, sig)
    assert not ec.schnorr_verify(msg[:-1] + [1], pk, sig)

    x, y, z = (Scalar(rng.randrange(N)) for _ in range(3))
    assert x + y == y + x and (x + y) + z == x + (y + z)
    assert x * (y + z) == x * y + x * z and (x * y) * z == x * (y * z)
    assert x - x == Scalar.zero() and x + (-x) == Scalar.zero()
    assert x * Scalar.one() == x and x * x.inverse() == Scalar.one()
    assert (x / y) * y == x and Scalar.zero().inverse() == Scalar.zero()
    assert x.square() == x * x and x.double() == x + x
    assert x.exp(5) == x * x * x * x * x
    buf = x.encode()
    assert len(buf) == 40 and Scalar.from_canonical_bytes(buf) == x
    big = (N + 1).to_bytes(40, "little")
    assert Scalar.from_canonical_bytes(big) is None
    assert Scalar.from_noncanonical_bytes(big) == Scalar(1)
    limbs = tuple(rng.randrange(ORDER) for _ in range(5))
    assert Scalar.from_gfp5(limbs) == Scalar(
        sum(v << (64 * i) for i, v in enumerate(limbs)) % N)
    assert Scalar.from_hashout(limbs[1:]) == \
        Scalar.from_gfp5((0,) + limbs[1:])
    for w in (2, 5, 10):
        s = Scalar(rng.randrange(N))
        digits = s.recode_signed(-(-320 // w) + 1, w)
        assert all(-(1 << (w - 1)) <= d < (1 << (w - 1)) for d in digits)
        assert digits[-1] >= 0
        assert sum(d << (w * i) for i, d in enumerate(digits)) == s.v
    for k in (0, 1, 2, N - 1, rng.randrange(N)):
        p, q = ec.mulgen(k), ec.GENERATOR.mul(k)
        assert p.is_inf == q.is_inf
        assert p.is_inf or (p.x, p.y) == (q.x, q.y)


def test_mul_gfp5_gate():
    """test_ecgfp5_gadgets.py's gate test: out = c * (a * b) in GF(p^5)."""
    rng = random.Random(61)
    g = gfp5.MulGFp5Gate.from_config(CircuitConfig.standard_recursion_config())
    c = rng.randrange(ORDER)
    ins = {w: rng.randrange(ORDER) for i in range(g.num_ops())
           for w in list(g.wires_multiplicand_0(i))
           + list(g.wires_multiplicand_1(i))}
    wires = run_gate(g, ins, [c])
    assert_vanishes(g, wires, [c])
    a = tuple(wires[w] for w in g.wires_multiplicand_0(0))
    b = tuple(wires[w] for w in g.wires_multiplicand_1(0))
    assert tuple(wires[w] for w in g.wires_output(0)) == \
        ref.extn_scalar_mul(ref.extn_mul(a, b, ec.W), c)


def test_quintic_and_curve_gadgets_witness():
    """test_ecgfp5_gadgets.py's circuit: quintic mul, quotient, inverse;
    curve add, double and encode against the native curve."""
    rng = random.Random(62)
    rand5 = lambda: tuple(rng.randrange(ORDER) for _ in range(5))
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    a_val, b_val = rand5(), rand5()
    a = builder.add_virtual_quintic_ext_target()
    b = builder.add_virtual_quintic_ext_target()
    prod = builder.mul_quintic_ext(a, b)
    quot = builder.div_or_zero_quintic_ext(a, b)
    inv = builder.inverse_quintic_ext(b)
    p_val = ec.GENERATOR.mul(rng.randrange(2, 1000))
    q_val = ec.GENERATOR.mul(rng.randrange(1000, 2000))
    p = builder.add_virtual_curve_target()
    q = builder.add_virtual_curve_target()
    s = builder.curve_add_gfp5(p, q)
    d = builder.curve_double_gfp5(p)
    enc = builder.curve_encode_to_quintic_ext(p)
    pw = PartialWitness()
    gfp5.set_quintic_ext_target(pw, a, a_val)
    gfp5.set_quintic_ext_target(pw, b, b_val)
    gfp5.set_curve_target(pw, p, p_val)
    gfp5.set_curve_target(pw, q, q_val)
    host, witness = _witness(builder, pw)
    get5 = lambda t: tuple(witness.get(x) for x in t)
    b_inv = ref.extn_inverse(b_val, ec.W, ec.DTH_ROOT)
    assert get5(prod) == ref.extn_mul(a_val, b_val, ec.W)
    assert get5(quot) == ref.extn_mul(a_val, b_inv, ec.W)
    assert get5(inv) == b_inv
    sv, dv = p_val.add(q_val), p_val.double()
    assert (get5(s.x), get5(s.y), witness.get(s.is_inf)) == (sv.x, sv.y, 0)
    assert (get5(d.x), get5(d.y)) == (dv.x, dv.y)
    assert get5(enc) == p_val.encode()
    _check_all_rows(host, witness)


def _lookup_pis(builder, pw):
    host, witness = _witness(builder, pw)
    _check_all_rows(host, witness)
    return [witness.get(t) for t in host.public_inputs]


def _lookup_builder():
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    return builder, builder.add_virtual_target(), builder.add_virtual_target()


def test_lookups():
    """test_lookup.py: one table looked up twice, two tables chained (the
    card's lookups phase), many lookups over several LookupGate rows, the
    same table registered twice, different inputs into a 2^10 table, a 2^12
    table from a function, and a table never looked up."""
    builder, a, b = _lookup_builder()
    idx = builder.add_lookup_table_from_pairs(
        [(i, (i * i + 7) % 256) for i in range(256)])
    outs = [builder.add_lookup_from_index(t, idx) for t in (a, b)]
    builder.register_public_inputs([a, b] + outs)
    pw = PartialWitness()
    pw.set_target(a, 1)
    pw.set_target(b, 2)
    assert _lookup_pis(builder, pw) == [1, 2, 8, 11]

    builder, pw, want = gadget_circuits.two_luts(PORT)
    assert _lookup_pis(builder, pw) == want

    table = [(i, (i * 97 + 31) % 256) for i in range(256)]
    t_fn = dict(table)
    builder, a, b = _lookup_builder()
    idx = builder.add_lookup_table_from_pairs(table)
    out_a, out_b = (builder.add_lookup_from_index(t, idx) for t in (a, b))
    s = builder.add(out_a, out_b)
    for _ in range(514):
        builder.add_lookup_from_index(a, idx)
    idx2 = builder.add_lookup_table_from_pairs(
        [(i, (3 * i) % 512) for i in range(512)])
    final = builder.add_lookup_from_index(s, idx2)
    builder.register_public_inputs([a, b, s, out_a, out_b, final])
    pw = PartialWitness()
    pw.set_target(a, 1)
    pw.set_target(b, 2)
    total = t_fn[1] + t_fn[2]
    assert _lookup_pis(builder, pw) == [1, 2, total, t_fn[1], t_fn[2],
                                        (3 * total) % 512]

    table = [(i, (i * 97 + 31) % 128) for i in range(256)]
    t_fn = dict(table)
    builder, a, b = _lookup_builder()
    i1 = builder.add_lookup_table_from_pairs(table)
    o_a, o_b = (builder.add_lookup_from_index(t, i1) for t in (a, b))
    s = builder.add(o_a, o_b)
    i2 = builder.add_lookup_table_from_pairs(table)
    assert i2 != i1
    final = builder.add_lookup_from_index(s, i2)
    builder.register_public_inputs([a, b, s, o_a, o_b, final])
    total = t_fn[1] + t_fn[2]
    assert _lookup_pis(builder, pw) == [1, 2, total, t_fn[1], t_fn[2],
                                        t_fn[total]]

    t_fn = {i: (i * 7 + 5) % 1024 for i in range(1024)}
    builder, a, b = _lookup_builder()
    idx = builder.add_lookup_table_from_pairs(list(t_fn.items()))
    outs = [builder.add_lookup_from_index(t, idx) for t in (a, b)]
    builder.register_public_inputs([a, b] + outs)
    pw = PartialWitness()
    pw.set_target(a, 123)
    pw.set_target(b, 800)
    assert _lookup_pis(builder, pw) == [123, 800, t_fn[123], t_fn[800]]

    builder, a, b = _lookup_builder()
    idx = builder.add_lookup_table_from_fn(lambda i: i // 10, range(1 << 12))
    builder.register_public_inputs(
        [builder.add_lookup_from_index(t, idx) for t in (a, b)])
    pw = PartialWitness()
    pw.set_target(a, 51)
    pw.set_target(b, 2)
    assert _lookup_pis(builder, pw) == [5, 0]

    builder, a, _ = _lookup_builder()
    builder.add_lookup_table_from_pairs([(i, i + 1) for i in range(16)])
    builder.register_public_input(builder.add(a, a))
    pw = PartialWitness()
    pw.set_target(a, 3)
    assert _lookup_pis(builder, pw) == [6]


def test_lookup_failures():
    """test_lookup.py: an unregistered table, and an input outside the
    table's domain, which the fixpoint refuses."""
    builder, a, _ = _lookup_builder()
    with pytest.raises(AssertionError):
        builder.add_lookup_from_index(a, 0)
    idx = builder.add_lookup_table_from_pairs(
        [(i, (i * 97 + 31) % 256) for i in range(256)])
    builder.register_public_inputs([a, builder.add_lookup_from_index(a, idx)])
    pw = PartialWitness()
    pw.set_target(a, 256)
    with pytest.raises(ValueError, match="outside the table domain"):
        _witness(builder, pw)


def test_ecdsa_native():
    """test_ecdsa_native.py: curve ops, GLV decomposition, mul = msm =
    glv_mul, ECDSA sign/verify."""
    rng = random.Random(41)
    g2 = secp.GENERATOR.double()
    assert secp.GENERATOR.is_valid() and g2.is_valid()
    assert secp.GENERATOR.add(secp.GENERATOR) == g2
    assert secp.GENERATOR.mul(secp.N).zero
    assert secp.GENERATOR.add(secp.GENERATOR.neg()).zero
    for _ in range(5):
        k = rng.randrange(1, secp.N)
        k1, k2, k1_neg, k2_neg = secp.decompose_secp256k1_scalar(k)
        s1 = (-k1 if k1_neg else k1) % secp.N
        s2 = (-k2 if k2_neg else k2) % secp.N
        assert (s1 + secp.GLV_S * s2) % secp.N == k
        assert k1 < (1 << 129) and k2 < (1 << 129)
    for _ in range(3):
        k = rng.randrange(1, secp.N)
        a = secp.GENERATOR.mul(k)
        b = secp.msm([k], [secp.GENERATOR])
        c = secp.glv_mul(secp.GENERATOR, k)
        assert (a.x, a.y) == (b.x, b.y) == (c.x, c.y)
    sk = secp.ECDSASecretKey(rng.randrange(1, secp.N))
    pk = sk.to_public()
    msg = rng.randrange(secp.N)
    sig = secp.sign_message(msg, sk)
    assert secp.verify_message(msg, sig, pk)
    assert not secp.verify_message((msg + 1) % secp.N, sig, pk)


def test_curve_add_double_valid():
    """test_curve_gadgets.py:28, the card's secp256k1-curve circuit: add,
    double and neg equal the native curve's, every row holds, and all five
    u32 gate types are laid out."""
    builder, pw, points = gadget_circuits.secp256k1_curve(PORT)
    host, witness = _witness(builder, pw)
    for name, (t, want) in points.items():
        assert gadget_circuits.point_value(PORT, witness, t) == want, name
    kinds = {g.id().split(" ")[0] for g in host.common.gates}
    assert {"U32ArithmeticGate", "U32AddManyGate", "U32SubtractionGate",
            "ComparisonGate", "U32RangeCheckGate"} <= kinds
    assert host.common.degree_bits == 10
    _check_all_rows(host, witness)


def test_interpolation_gates():
    """test_gates.py:84: the interpolant of the generator's coefficients
    equals direct Lagrange interpolation over the coset at the point."""
    rng = random.Random(84)
    r = lambda: rng.randrange(ORDER)
    for g in (interp.HighDegreeInterpolationGate(2),
              interp.LowDegreeInterpolationGate(2)):
        ins = {g.wire_shift(): r()}
        values = []
        for i in range(g.num_points()):
            values.append((r(), r()))
            ins.update(zip(g.wires_value(i), values[-1]))
        ep = (r(), r())
        ins.update(zip(g.wires_evaluation_point(), ep))
        wires = run_gate(g, ins)
        assert_vanishes(g, wires)
        root = ref.primitive_root_of_unity(g.subgroup_bits)
        pts = [ref.mul(ins[g.wire_shift()], ref.exp(root, i))
               for i in range(g.num_points())]
        want = (0, 0)
        for i, (x_i, v) in enumerate(zip(pts, values)):
            num, den = (1, 0), 1
            for j, x_j in enumerate(pts):
                if i != j:
                    num = ref.ext2_mul(num, ref.ext2_sub(ep, (x_j, 0)))
                    den = ref.mul(den, ref.sub(x_i, x_j))
            want = ref.ext2_add(want, ref.ext2_scalar_mul(
                ref.ext2_mul(num, v), ref.inverse(den)))
        assert tuple(wires[w] for w in g.wires_evaluation_value()) == want


def test_poseidon_mds_gate():
    """test_gates.py:216."""
    rng = random.Random(216)
    g = mg.PoseidonMdsGate()
    assert_vanishes(g, run_gate(g, {w: rng.randrange(ORDER)
                                      for i in range(12)
                                      for w in g.wires_input(i)}))


# ---------------------------------------------------------------------------
# The Schnorr circuit against JAX (host level: 2^12 is never proved here)
# ---------------------------------------------------------------------------

_SCHNORR = {}


def _schnorr():
    """(port builder, port host, port witness, JAX builder, JAX data, JAX
    witness), built once."""
    if not _SCHNORR:
        builder, pw = gadget_circuits.schnorr(PORT)
        rows = [(g.id(), list(c)) for g, c in builder.gate_instances]
        copies = list(builder.copy_constraints)
        host, witness = _witness(builder, pw)
        jbuilder, jpw = gadget_circuits.schnorr(JAX)
        jrows = [(g.id(), list(c)) for g, c in jbuilder.gate_instances]
        jcopies = list(jbuilder.copy_constraints)
        jdata = jbuilder.build()
        jwitness = jgenerate_partial_witness(jpw, jdata.prover_only,
                                             jdata.common)
        _SCHNORR.update(rows=(rows, jrows), copies=(copies, jcopies),
                        host=host, witness=witness, jdata=jdata,
                        jwitness=jwitness)
    return _SCHNORR


def test_schnorr_layout_matches_jax():
    """Gate instances (ids and constants, in order) and copy constraints,
    before build pads and routes the constants: 3,231 rows, 188,513 copy
    constraints."""
    s = _schnorr()
    rows, jrows = s["rows"]
    copies, jcopies = s["copies"]
    assert len(rows) == 3231 and len(copies) == 188513
    assert rows == jrows
    assert copies == jcopies


def test_schnorr_common_constants_sigmas_match_jax():
    """build_host() against JAX's build(): CommonCircuitData field by
    field (2^12, 13 gate types), the constants and sigmas values, the
    representative map."""
    s = _schnorr()
    host, jdata = s["host"], s["jdata"]
    common = host.common
    assert common_from(jdata.common) == common
    assert common.degree_bits == 12 and len(common.gates) == 13
    kinds = " ".join(g.id() for g in common.gates)
    for kind in ("MulGFp5Gate", "ComparisonGate", "U32ArithmeticGate",
                 "U32AddManyGate", "RandomAccessGate", "PoseidonGate"):
        assert kind in kinds
    po = jdata.prover_only
    nc = common.num_constants
    np.testing.assert_array_equal(host.constants_sigmas[nc:], po.sigmas)
    np.testing.assert_array_equal(host.representative_map,
                                  po.representative_map)
    coeffs = ntt.ifft(gl.from_u64(host.constants_sigmas[:nc], "cpu"))
    np.testing.assert_array_equal(
        gl.to_u64(coeffs),
        po.constants_sigmas_commitment.polynomials.to_u64()[:nc])


def test_schnorr_witness_matches_jax():
    """Every wire of both fixpoints, and every target JAX sets; every row
    of the port's witness holds."""
    s = _schnorr()
    np.testing.assert_array_equal(s["witness"].full_witness(),
                                  s["jwitness"].full_witness())
    assert s["witness"].as_list() == s["jwitness"].values
    _check_all_rows(s["host"], s["witness"])


def test_schnorr_tampered_signature_makes_no_witness():
    """test_schnorr_circuit.py:49-63: a signature with s + 1 verifies
    natively to False and its circuit's fixpoint raises."""
    builder, pw = gadget_circuits.schnorr(PORT, tamper=True)
    with pytest.raises(AssertionError, match="set twice"):
        _witness(builder, pw)


# ---------------------------------------------------------------------------
# A gadget circuit under standard_ecc_config(), proved on the CPU
# ---------------------------------------------------------------------------

def _gadget_mix(builder, pw_cls):
    """u32 mul_add/add_many/sub/range check/comparison, a lookup, quintic
    mul and inverse, and a BigUint div_rem: 2^5 under 136 wires."""
    a, b, x = (builder.add_virtual_target() for _ in range(3))
    lo, hi = builder.mul_add_u32(a, b, builder.constant_u32(77))
    s, _ = builder.add_many_u32([lo, hi, builder.constant_u32(5)])
    d, borrow = builder.sub_u32(s, lo)
    builder.range_check_u32([d, borrow])
    le = builder.list_le_u32([lo], [hi])
    idx = builder.add_lookup_table_from_pairs([(i, i * i % 251)
                                               for i in range(64)])
    sq = builder.add_lookup_from_index(x, idx)
    q = builder.add_virtual_quintic_ext_target()
    prod = builder.mul_quintic_ext(q, builder.inverse_quintic_ext(q))
    big = builder.add_virtual_biguint_target(2)
    div, rem = builder.div_rem_biguint(big, builder.constant_biguint(10007))
    builder.register_public_inputs([a, b, lo, hi, s, d, le, sq]
                                   + list(prod) + list(div.limbs)
                                   + list(rem.limbs))
    pw = pw_cls()
    values = {a: 0xDEADBEEF, b: 0x12345678, x: 9}
    values.update(zip(q, (3, 1, 4, 1, 5)))
    values.update(zip(big.limbs, (0x9ABCDEF0, 0x12345678)))
    for t, v in values.items():
        pw.set_target(t, v)
    return pw


def _expected_mix():
    val = 0xDEADBEEF * 0x12345678 + 77
    lo, hi = val & 0xFFFFFFFF, val >> 32
    s = (lo + hi + 5) & 0xFFFFFFFF
    big = 0x123456789ABCDEF0
    return ([0xDEADBEEF, 0x12345678, lo, hi, s, (s - lo) % (1 << 32),
             int(lo <= hi), 81, 1, 0, 0, 0, 0]
            + [(big // 10007) & 0xFFFFFFFF, (big // 10007) >> 32,
               big % 10007])


_MIX = {}


def _mix():
    """(port data, port proof, JAX data, JAX partial witness), once."""
    if not _MIX:
        builder = CircuitBuilder(CircuitConfig.standard_ecc_config(),
                                 seed=gadget_circuits.SEED)
        pw = _gadget_mix(builder, PartialWitness)
        data = builder.build(device="cpu")
        jbuilder = JBuilder(JCircuitConfig.standard_ecc_config(),
                            seed=gadget_circuits.SEED)
        jpw = _gadget_mix(jbuilder, JPartialWitness)
        _MIX.update(data=data, proof=data.prove(pw), jdata=jbuilder.build(),
                    jpw=jpw)
    return _MIX


def test_gadget_circuit_proves_and_jax_verifies():
    """The port proves and verifies the 136-wire circuit on the CPU; the
    JAX package reads its bytes back and verifies them; a flipped public
    input is rejected."""
    m = _mix()
    data, proof, jdata = m["data"], m["proof"], m["jdata"]
    assert data.common.degree_bits == 5
    assert data.common.config.num_wires == 136
    assert proof.public_inputs == _expected_mix()
    assert list(data.verifier_only.circuit_digest) == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    data.verify(proof)
    raw = serialize_proof_with_pis(proof, data.common)
    jproof = jser.deserialize_proof_with_pis(raw, jdata.common)
    assert jser.serialize_proof_with_pis(jproof, jdata.common) == raw
    jverifier.verify(jproof, jdata.verifier_only, jdata.common)
    jproof.public_inputs[0] = (jproof.public_inputs[0] + 1) % ORDER
    with pytest.raises(AssertionError):
        jverifier.verify(jproof, jdata.verifier_only, jdata.common)


def test_jax_built_gadget_circuit_converts_and_proves():
    """The same circuit built by JAX, carried over by `convert.py` (its
    gates, the lookup's table included, and every generator), proved and
    verified by the port with the public inputs of the port's own proof."""
    m = _mix()
    jdata = m["jdata"]
    po = jdata.prover_only
    tree = po.constants_sigmas_commitment.merkle_tree
    data = circuit_data_from_arrays(
        jdata.common,
        polynomials=po.constants_sigmas_commitment.polynomials.to_u64(),
        leaves=tree.leaves_host(),
        layers=[np.asarray(l) for l in tree._layers_host()],
        sigmas=po.sigmas, subgroup=po.subgroup,
        representative_map=po.representative_map,
        circuit_digest=po.circuit_digest, generators=po.generators,
        public_inputs=po.public_inputs, device="cpu")
    assert data.common == m["data"].common
    got, want = data.prover_only.generators, m["data"].prover_only.generators
    assert [type(g).__name__ for g in got] == [type(g).__name__ for g in want]
    pw = PartialWitness()
    for t, v in m["jpw"].values.items():
        pw.set_target(tuple(t), v)
    proof = data.prove(pw)
    assert proof.public_inputs == m["proof"].public_inputs
    data.verify(proof)


def test_jax_nonnative_and_glv_generators_convert():
    """The generators the gadget circuit lacks, carried over from a JAX
    circuit of nonnative add/sub/mul/inv and a GLV decomposition: their
    fields equal the port-built circuit's, and the fixpoint over the
    converted generators fills the same witness."""
    def layout(builder, mod, gadgets_mod):
        a = builder.add_virtual_nonnative_target(mod.P)
        b = builder.add_virtual_nonnative_target(mod.P)
        k = builder.add_virtual_nonnative_target(mod.N)
        k1 = builder.add_virtual_nonnative_target(mod.N)
        k2 = builder.add_virtual_nonnative_target(mod.N)
        n1, n2 = builder.add_virtual_target(), builder.add_virtual_target()
        builder.add_nonnative(a, b)
        builder.sub_nonnative(a, b)
        builder.mul_nonnative(a, b)
        builder.inv_nonnative(b)
        builder.add_simple_generator(gadgets_mod._GlvDecompositionGenerator(
            k, k1, k2, n1, n2))
        for t in (k1, k2):
            builder.range_check_u32(list(t.value.limbs))
        return a, b, k

    builder = CircuitBuilder(CircuitConfig.standard_ecc_config(), seed=5)
    a, b, k = layout(builder, secp, curve_gadgets)
    host = builder.build_host()
    jbuilder = JBuilder(JCircuitConfig.standard_ecc_config(), seed=5)
    layout(jbuilder, jsecp, jcurve_gadgets)
    jdata = jbuilder.build()
    got = [generator_from(g) for g in jdata.prover_only.generators]
    kinds = {type(g).__name__ for g in got}
    assert {"_NonNativeAdditionGenerator", "_NonNativeSubtractionGenerator",
            "_NonNativeMultiplicationGenerator", "_NonNativeInverseGenerator",
            "_GlvDecompositionGenerator", "_U32RangeCheckGenerator"} <= kinds
    assert [type(g).__name__ for g in got] == \
        [type(g).__name__ for g in host.generators]
    for g, w in zip(got, host.generators):
        gv = {n: v.id() if hasattr(v, "id") else v
              for n, v in vars(g).items() if n not in ("rng", "_deps")}
        wv = {n: v.id() if hasattr(v, "id") else v
              for n, v in vars(w).items() if n not in ("rng", "_deps")}
        assert gv == wv, type(g).__name__
    rng = random.Random(5)
    pw = PartialWitness()
    set_nonnative_target(pw, a, rng.randrange(secp.P))
    set_nonnative_target(pw, b, rng.randrange(1, secp.P))
    set_nonnative_target(pw, k, rng.randrange(secp.N))
    witness = generate_partial_witness(pw, host, host.common)
    host.generators = got
    assert generate_partial_witness(pw, host, host.common).as_list() == \
        witness.as_list()
