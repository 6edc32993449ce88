"""The port's gates of the recursive verifier circuit (plonky2_tpu_torch/gates/
extension_gates.py, misc_gates.py, coset_interpolation_gate.py) against the
JAX package's, at the parameters `standard_recursion_config()` gives them:
ids, wire / constant / constraint counts and degrees; the constraints over
extension scalars at zeta and over base-field rows; each generator's outputs
on the same partial witness, which make every constraint zero. Inputs come
from a numpy seed. Tolerance: exact.
"""

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.gates import coset_interpolation_gate as jcig
from plonky2_tpu.gates import extension_gates as jeg
from plonky2_tpu.gates import gate as jgate
from plonky2_tpu.gates import misc_gates as jmg
from plonky2_tpu.iop.witness import PartitionWitness as JPartitionWitness
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.gates import coset_interpolation_gate as cig
from plonky2_tpu_torch.gates import extension_gates as eg
from plonky2_tpu_torch.gates import gate
from plonky2_tpu_torch.gates import misc_gates as mg
from plonky2_tpu_torch.iop.target import wire
from plonky2_tpu_torch.iop.witness import PartitionWitness
from plonky2_tpu_torch.plonk.config import CircuitConfig

ORDER = (1 << 64) - (1 << 32) + 1
NUM_WIRES = 135
CONFIG = CircuitConfig.standard_recursion_config()
JCONFIG = JCircuitConfig.standard_recursion_config()
QDF = CONFIG.max_quotient_degree_factor

# name -> (the port's gate, the JAX package's gate)
GATES = {
    "arithmetic_extension": (eg.ArithmeticExtensionGate.from_config(CONFIG),
                             jeg.ArithmeticExtensionGate.from_config(JCONFIG)),
    "mul_extension": (eg.MulExtensionGate.from_config(CONFIG),
                      jeg.MulExtensionGate.from_config(JCONFIG)),
    "reducing_extension": (eg.ReducingExtensionGate(32),
                           jeg.ReducingExtensionGate(32)),
    "reducing": (eg.ReducingGate(43), jeg.ReducingGate(43)),
    "base_sum_4": (mg.BaseSumGate(4), jmg.BaseSumGate(4)),
    "base_sum_48": (mg.BaseSumGate(48), jmg.BaseSumGate(48)),
    "base_sum_64": (mg.BaseSumGate(64), jmg.BaseSumGate(64)),
    "exponentiation": (mg.ExponentiationGate.from_config(CONFIG),
                       jmg.ExponentiationGate.from_config(JCONFIG)),
    "random_access": (mg.RandomAccessGate.from_config(CONFIG, 4),
                      jmg.RandomAccessGate.from_config(JCONFIG, 4)),
    # the degree `interpolate_coset` picks: max_quotient_degree_factor
    "coset_interpolation": (cig.CosetInterpolationGate(4, QDF),
                            jcig.CosetInterpolationGate(4, QDF)),
}
NAMES = list(GATES)


def _rng(name, salt):
    return np.random.default_rng([NAMES.index(name), salt])


def _rand(rng, *shape):
    return rng.integers(0, ORDER, size=shape, dtype=np.uint64)


def test_gate_parameters_are_the_wraps():
    """The wraps' gate ids (tests/test_torch_recursion.py builds them)."""
    ids = [GATES[n][0].id() for n in NAMES]
    assert ids[:4] == ["ArithmeticExtensionGate { num_ops: 10 }",
                       "MulExtensionGate { num_ops: 13 }",
                       "ReducingExtensionGate { num_coeffs: 32 }",
                       "ReducingGate { num_coeffs: 43 }"]
    assert ids[6] == "BaseSumGate { num_limbs: 64 } + Base: 2"
    assert ids[8].startswith("RandomAccessGate { bits: 4, num_copies: 4, "
                             "num_extra_constants: 2,")
    assert ids[9].startswith("CosetInterpolationGate { subgroup_bits: 4, "
                             "degree: 6,")


@pytest.mark.parametrize("name", NAMES)
def test_gate_shape_matches_jax(name):
    g, j = GATES[name]
    assert g.id() == j.id()
    for attr in ("num_wires", "num_constants", "degree", "num_constraints",
                 "num_ops", "extra_constant_wires"):
        assert getattr(g, attr)() == getattr(j, attr)(), attr
    assert g.num_wires() <= NUM_WIRES


@pytest.mark.parametrize("name", NAMES)
def test_eval_unfiltered_ext_matches_jax(name):
    """Over extension scalars (the verifier at zeta), random wires."""
    g, j = GATES[name]
    rng = _rng(name, 0)
    wires = [tuple(int(v) for v in p) for p in _rand(rng, g.num_wires(), 2)]
    consts = [tuple(int(v) for v in p) for p in _rand(rng, 2, 2)]
    pi = [tuple(int(v) for v in p) for p in _rand(rng, 4, 2)]
    got = g.eval_unfiltered(gate.EXT, consts, wires, pi)
    assert len(got) == g.num_constraints()
    assert got == j.eval_unfiltered(jgate.EXT, consts, wires, pi)


@pytest.mark.parametrize("name", NAMES)
def test_eval_unfiltered_rows_matches_jax(name):
    """Over base-field rows [num_wires, 32] (the prover's quotient pass)."""
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


def _inputs(name, g, rng):
    """Values of the generators' dependencies: wire -> value."""
    deps = {}
    for gen in g.generators(0, [0, 0]):
        for t in gen.dependencies():
            deps[t[2]] = int(_rand(rng))
    if name.startswith("base_sum"):
        if g.num_limbs < 64:
            deps[g.WIRE_SUM] = int(rng.integers(0, 1 << g.num_limbs))
    elif name == "exponentiation":
        for i in range(g.num_power_bits):
            deps[g.wire_power_bit(i)] = int(rng.integers(0, 2))
    elif name == "random_access":
        for c in range(g.num_copies):
            deps[g.wire_access_index(c)] = int(rng.integers(0, g.vec_size()))
    return deps


def _run(generators, witness):
    out = []
    for gen in generators:
        buf = []
        assert gen.run(witness, buf)
        for t, v in buf:
            witness.set(t, v)
        out += [(tuple(t), int(v)) for t, v in buf]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_generators_match_jax_and_satisfy_the_gate(name):
    """On the same partial witness the port's generators write what JAX's
    write; with their outputs (and the build-time constants) every
    constraint is zero."""
    g, j = GATES[name]
    rng = _rng(name, 2)
    deps = _inputs(name, g, rng)
    consts = [int(v) for v in _rand(rng, g.num_constants())]
    rep = np.arange(NUM_WIRES, dtype=np.int64)
    witness = PartitionWitness(rep, NUM_WIRES, 1)
    jwitness = JPartitionWitness(rep, NUM_WIRES, 1)
    for w, v in deps.items():
        witness.set(wire(0, w), v)
        jwitness.set(wire(0, w), v)
    got = _run(g.generators(0, consts), witness)
    want = _run(j.generators(0, consts), jwitness)
    assert got == want and got
    assert witness.as_list() == jwitness.values
    for c, w in g.extra_constant_wires():
        witness.set(wire(0, w), consts[c])
    row = [(v or 0, 0) for v in witness.as_list()[:g.num_wires()]]
    ext_consts = [(c, 0) for c in consts]
    assert g.eval_unfiltered(gate.EXT, ext_consts, row, [(0, 0)] * 4) == \
        [(0, 0)] * g.num_constraints()
