"""The port's conditional and cyclic recursion (recursion/conditional.py,
recursion/cyclic.py, recursion/dummy.py, the builder's verifier-data public
inputs and its goal check) against the JAX package's.

Everything runs at the host level: the port lays its circuits out with
`build_host()` and runs their witness fixpoint; JAX `build()`s its side.
Nothing is proved at the cyclic circuit's degree here (a plain prove of
2^12 rows takes minutes on a CPU): the one proof of that shape the cyclic
witnesses need, a proof of the dummy circuit for the goal whose last public
inputs are its own verifier data, is a fixture made by this file's main
(`python tests/test_torch_cyclic.py`, about two minutes). The in-circuit
verifier connects values it computes, so the selected proof must be a valid
one; the other is random. The cyclic circuits use tests/test_cyclic.py's
reduced FRI config, padded to 2^11 rows before the build, which lands at
2^12; the chain proves on the card at standard_recursion_config()
(`chip_smoke.py`, phase cyclic-ivc). Tolerance: exact.
"""

import dataclasses
import os

import numpy as np
import pytest

import test_cyclic as jax_cyclic_test
from plonky2_tpu.iop.generator import \
    generate_partial_witness as jgenerate_partial_witness
from plonky2_tpu.iop.witness import PartialWitness as JPartialWitness
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.recursion import conditional as jconditional
from plonky2_tpu.recursion import cyclic as jcyclic
from plonky2_tpu.recursion import dummy as jdummy
from plonky2_tpu.recursion import targets as jtargets
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.convert import common_from, generator_from
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.circuit_data import VerifierOnlyData
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.verifier import verify
from plonky2_tpu_torch.recursion import conditional, cyclic, dummy, targets
from plonky2_tpu_torch.utils.serialization import (
    deserialize_proof_with_pis, serialize_proof_with_pis,
)

SEED = 1234
ORDER = (1 << 64) - (1 << 32) + 1
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "cyclic_reduced_dummy_proof.bin")
# the goal's degree under the reduced config: the verifier of a verifier
# of an empty circuit, padded to 2^11 rows, is built at 2^12
GOAL_DEGREE_BITS = 12


def _reduced_config():
    """tests/test_cyclic.py's `_test_config`, in the port's classes."""
    return dataclasses.replace(
        CircuitConfig.standard_recursion_config(),
        fri_config=FriConfig(
            rate_bits=3, cap_height=2, proof_of_work_bits=16,
            reduction_strategy=FriReductionStrategy(
                kind="constant_arity", arity_bits=4, final_poly_bits=5),
            num_query_rounds=8))


class _Recorder:
    """A PartialWitness-shaped list of (target, value) in the order set."""

    def __init__(self):
        self.pairs = []

    def set_target(self, t, v):
        self.pairs.append((t, int(v)))


def _fill(pw, pairs):
    for t, v in pairs:
        pw.set_target(t, v)
    return pw


def _host_witness(host, pairs):
    return generate_partial_witness(_fill(PartialWitness(), pairs), host,
                                    host.common)


def _jax_witness(data, pairs):
    return jgenerate_partial_witness(_fill(JPartialWitness(), pairs),
                                     data.prover_only, data.common)


def _assert_layouts_equal(host, jdata):
    """Gates, selectors, CommonCircuitData, sigmas, representative maps
    and the constants (the port's values, interpolated by its plain iNTT,
    against the JAX commitment's coefficients)."""
    common = host.common
    assert common_from(jdata.common) == common
    assert [g.id() for g in common.gates] == \
        [g.id() for g in jdata.common.gates]
    po = jdata.prover_only
    nc = common.num_constants
    np.testing.assert_array_equal(host.constants_sigmas[nc:], po.sigmas)
    np.testing.assert_array_equal(host.representative_map,
                                  po.representative_map)
    coeffs = ntt.ifft(gl.from_u64(host.constants_sigmas[:nc], "cpu"))
    np.testing.assert_array_equal(
        gl.to_u64(coeffs),
        po.constants_sigmas_commitment.polynomials.to_u64()[:nc])


def _assert_witnesses_equal(witness, jwitness):
    np.testing.assert_array_equal(witness.full_witness(),
                                  jwitness.full_witness())
    assert witness.as_list() == jwitness.values


# -- conditional recursion (tests/test_conditional.py's circuit) ------------

def _fib(builder, steps):
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(steps):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    return a, b


def _conditional_outer(builder, t, config, common):
    """The outer circuit: verify proof 0 where its condition is 1, else
    proof 1. Returns (condition, proof targets, verifier-data targets)."""
    condition = builder.add_virtual_target()
    builder.assert_bool(condition)
    pts = [t.add_virtual_proof_with_pis(builder, common) for _ in range(2)]
    vts = [t.add_virtual_verifier_data(builder, config.fri_config.cap_height)
           for _ in range(2)]
    return condition, pts, vts


_CACHE = {}


def _conditional():
    """(port host, port inputs(cond), JAX data, JAX inputs(cond)), built
    once: the port proves fib(100) and fib(99) on the CPU, both packages
    lay out the outer circuit, and JAX reads the port's proofs back from
    their bytes."""
    if "conditional" in _CACHE:
        return _CACHE["conditional"]
    config = CircuitConfig.standard_recursion_config()
    inner = []
    for steps in (99, 98):
        builder = CircuitBuilder(config, seed=SEED)
        a, b = _fib(builder, steps)
        data = builder.build(device="cpu")
        pw = PartialWitness()
        pw.set_target(a, 0)
        pw.set_target(b, 1)
        inner.append((data, data.prove(pw)))
    (data0, proof0), (data1, _) = inner
    assert data0.common.same_shape(data1.common)
    assert data0.verifier_only.circuit_digest != \
        data1.verifier_only.circuit_digest

    builder = CircuitBuilder(config, seed=SEED)
    condition, pts, vts = _conditional_outer(builder, targets, config,
                                             data0.common)
    conditional.conditionally_verify_proof(builder, condition, pts[0],
                                           vts[0], pts[1], vts[1],
                                           data0.common)
    host = builder.build_host()

    jconfig = JCircuitConfig.standard_recursion_config()
    jinner = []
    for (data, proof), steps in zip(inner, (99, 98)):
        jb = JBuilder(jconfig, seed=SEED)
        _fib(jb, steps)
        jdata = jb.build()
        assert list(data.verifier_only.circuit_digest) == \
            [int(x) for x in jdata.verifier_only.circuit_digest]
        jinner.append((jdata, jser.deserialize_proof_with_pis(
            serialize_proof_with_pis(proof, data.common), jdata.common)))
    jb = JBuilder(jconfig, seed=SEED)
    jcondition, jpts, jvts = _conditional_outer(jb, jtargets, jconfig,
                                                jinner[0][0].common)
    jconditional.conditionally_verify_proof(jb, jcondition, jpts[0], jvts[0],
                                            jpts[1], jvts[1],
                                            jinner[0][0].common)
    jouter = jb.build()

    def inputs(cond):
        pw = PartialWitness()
        pw.set_target(condition, cond)
        for pt, vt, (data, proof) in zip(pts, vts, inner):
            targets.set_proof_with_pis_target(pw, pt, proof)
            targets.set_verifier_data_target(pw, vt, data.verifier_only)
        return pw

    def jinputs(cond):
        pw = JPartialWitness()
        pw.set_target(jcondition, cond)
        for pt, vt, (data, proof) in zip(jpts, jvts, jinner):
            jtargets.set_proof_with_pis_target(pw, pt, proof)
            jtargets.set_verifier_data_target(pw, vt, data.verifier_only)
        return pw
    _CACHE["conditional"] = host, inputs, jouter, jinputs
    return _CACHE["conditional"]


def test_conditional_circuit_layout_matches_jax():
    host, _, jouter, _ = _conditional()
    assert host.common.degree_bits == jouter.common.degree_bits == 12
    _assert_layouts_equal(host, jouter)


@pytest.mark.parametrize("cond", [1, 0])
def test_conditional_witness_matches_jax(cond):
    """Every wire, with proof 0 (cond 1) or proof 1 (cond 0) verified."""
    host, inputs, jouter, jinputs = _conditional()
    witness = generate_partial_witness(inputs(cond), host, host.common)
    jwitness = jgenerate_partial_witness(jinputs(cond), jouter.prover_only,
                                         jouter.common)
    _assert_witnesses_equal(witness, jwitness)


# -- cyclic recursion (tests/test_cyclic.py's hash chain) -------------------

def _chain(builder, t, cyclic_mod, common):
    """The hash-chain circuit of the reference's test_cyclic_recursion,
    whose other proof is an explicit target (the `_or_dummy` variant proves
    at build time). Sets `common.num_public_inputs`. Returns (condition,
    verifier-data target, inner proof target, other proof target, other
    verifier-data target)."""
    one = builder.one()
    initial_hash = builder.add_virtual_targets(4)
    builder.register_public_inputs(initial_hash)
    current_hash_in = builder.add_virtual_targets(4)
    builder.register_public_inputs(
        builder.hash_n_to_hash_no_pad(list(current_hash_in)))
    counter = builder.add_virtual_target()
    builder.register_public_input(counter)
    vd = builder.add_verifier_data_public_inputs()
    common.num_public_inputs = len(builder.public_inputs)
    condition = builder.add_virtual_target()
    builder.assert_bool(condition)
    inner = t.add_virtual_proof_with_pis(builder, common)
    pis = inner.public_inputs
    for a, b in zip(initial_hash, pis[0:4]):
        builder.connect(a, b)
    for a, x, y in zip(current_hash_in, pis[4:8], initial_hash):
        builder.connect(a, builder.select(condition, x, y))
    builder.connect(counter, builder.mul_add(condition, pis[8], one))
    other = t.add_virtual_proof_with_pis(builder, common)
    other_vd = t.add_virtual_verifier_data(builder,
                                           common.config.fri_config.cap_height)
    cyclic_mod.conditionally_verify_cyclic_proof(builder, condition, inner,
                                                 other, other_vd, common)
    return condition, vd, inner, other, other_vd


def _goals():
    """(port goal, JAX goal): the port's `common_data_for_recursion` and
    tests/test_cyclic.py's fixpoint, with the chain's public inputs."""
    if "goals" not in _CACHE:
        goal = cyclic.common_data_for_recursion(_reduced_config(),
                                                GOAL_DEGREE_BITS)
        jgoal = jax_cyclic_test._common_data_for_recursion(
            jax_cyclic_test._test_config())
        _CACHE["goals"] = goal, jgoal
    return _CACHE["goals"]


def _fixture(goal):
    """The fixture proof, and its verifier data read from its last public
    inputs (its own)."""
    with open(FIXTURE, "rb") as f:
        proof = deserialize_proof_with_pis(f.read(), goal)
    digest, cap = cyclic.verifier_data_from_public_inputs(
        proof.public_inputs, goal)
    return proof, VerifierOnlyData(constants_sigmas_cap=[tuple(h)
                                                         for h in cap],
                                   circuit_digest=tuple(digest))


def _random_like(pt, proof, rng):
    """(target, value) pairs filling `pt` with random values (the targets
    of `set_proof_with_pis_target`, in its order)."""
    rec = _Recorder()
    targets.set_proof_with_pis_target(rec, pt, proof)
    return [(t, int(v)) for (t, _), v in
            zip(rec.pairs, rng.integers(0, ORDER, len(rec.pairs),
                                        dtype=np.uint64))]


def _chains():
    """(port host, JAX data, inputs(cond)): the hash chain laid out by both
    packages on their goals; inputs(cond) are the (target, value) pairs of a
    step with that condition."""
    if "chains" in _CACHE:
        return _CACHE["chains"]
    goal, jgoal = _goals()
    host, inputs = port_chain(goal)
    jb = JBuilder(jgoal.config, seed=SEED)
    _chain(jb, jtargets, jcyclic, jgoal)
    jdata = jb.build()
    _CACHE["chains"] = host, jdata, inputs
    return _CACHE["chains"]


def port_chain(goal):
    """(port host, inputs(cond)): the hash chain laid out by the port on
    `goal` (`cyclic.common_data_for_recursion(_reduced_config(),
    GOAL_DEGREE_BITS)`), and the (target, value) pairs of a step with
    condition `cond`."""
    builder = CircuitBuilder(goal.config, seed=SEED)
    condition, vd, inner, other, other_vd = _chain(builder, targets, cyclic,
                                                   goal)
    host = builder.build_host()
    proof, proof_vd = _fixture(goal)
    rng = np.random.default_rng(5)
    # the verifier data written into the circuit: the fixture's own where
    # the cyclic proof is the one verified (cond 1), random where not
    random_vd = VerifierOnlyData(
        constants_sigmas_cap=[tuple(int(x) for x in rng.integers(
            0, ORDER, 4, dtype=np.uint64))
            for _ in range(goal.config.fri_config.num_cap_elements)],
        circuit_digest=tuple(int(x) for x in rng.integers(
            0, ORDER, 4, dtype=np.uint64)))

    n = goal.num_public_inputs
    vk_pairs = 4 + 4 * goal.config.fri_config.num_cap_elements

    def inputs(cond):
        """cond 1: the fixture verified as the cyclic proof, under its own
        verifier data, the other proof random; cond 0: the fixture verified
        as the other proof, the cyclic proof random but for its last public
        inputs, which carry the circuit's (random) verifier data."""
        rec = _Recorder()
        rec.set_target(condition, cond)
        own = proof_vd if cond else random_vd
        if cond:
            targets.set_proof_with_pis_target(rec, inner, proof)
            rec.pairs += _random_like(other, proof, rng)
        else:
            pairs = _random_like(inner, proof, rng)
            assert [t for t, _ in pairs[:n]] == inner.public_inputs
            vk = list(own.circuit_digest) + [
                x for h in own.constants_sigmas_cap for x in h]
            pairs[n - vk_pairs:n] = [
                (t, v) for (t, _), v in zip(pairs[n - vk_pairs:n], vk)]
            rec.pairs += pairs
            targets.set_proof_with_pis_target(rec, other, proof)
        targets.set_verifier_data_target(rec, other_vd,
                                         random_vd if cond else proof_vd)
        targets.set_verifier_data_target(rec, vd, own)
        return rec.pairs

    return host, inputs


def test_common_data_for_recursion_matches_jax():
    """The port's goal equals tests/test_cyclic.py's fixpoint field by
    field, and `same_shape` holds both ways."""
    goal, jgoal = _goals()
    converted = common_from(jgoal)
    assert goal.degree_bits == jgoal.degree_bits == GOAL_DEGREE_BITS
    assert converted == goal
    assert goal.same_shape(converted) and converted.same_shape(goal)
    assert jgoal.same_shape(jgoal)
    assert "ConstantGate { num_consts: 2 }" in [g.id() for g in goal.gates]


def test_hash_chain_layout_matches_jax():
    host, jdata, _ = _chains()
    goal, _ = _goals()
    assert host.common.same_shape(goal)
    _assert_layouts_equal(host, jdata)


@pytest.mark.parametrize("cond", [0, 1])
def test_hash_chain_witness_matches_jax(cond):
    """Every wire of a step: the fixture proof verified as the other proof
    (cond 0) or as the circuit's own (cond 1), the hash and the counter."""
    host, jdata, inputs = _chains()
    pairs = inputs(cond)
    witness = _host_witness(host, pairs)
    _assert_witnesses_equal(witness, _jax_witness(jdata, pairs))
    pis = [witness.get(t) for t in host.public_inputs]
    inner_pis = dict(pairs)
    inner = [inner_pis[t] for t, _ in pairs[1:1 + len(pis)]]
    latest = inner[4:8] if cond else pis[0:4]
    assert pis[0:4] == inner[0:4]
    from plonky2_tpu_torch.hash.hashers import POSEIDON
    assert pis[4:8] == list(POSEIDON.hash_no_pad_oracle(latest))
    assert pis[8] == (inner[8] + 1 if cond else 1)


def test_fixture_is_a_proof_of_the_goals_shape():
    """The fixture verifies under the verifier data in its own last public
    inputs, at the goal's shape."""
    goal, _ = _goals()
    proof, vd = _fixture(goal)
    verify(proof, vd, goal)
    cyclic.check_cyclic_proof_verifier_data(proof, vd, goal)


def test_dummy_circuit_for_common_layout_matches_jax():
    goal, jgoal = _goals()
    _chains()                       # sets the goals' public-input counts
    builder, _ = dummy.dummy_builder_for_common(goal)
    host = builder.build_host(min_degree_bits=goal.degree_bits)
    assert host.common.same_shape(goal)
    jdata, _ = jdummy.dummy_circuit_for_common(jgoal)
    _assert_layouts_equal(host, jdata)


def test_dummy_proof_generator_sets_the_proof_and_verifier_data():
    """DummyProofGenerator writes what set_proof_with_pis_target and
    set_verifier_data_target write, and what JAX's generator writes."""
    goal, jgoal = _goals()
    _chains()
    proof, vd = _fixture(goal)
    builder = CircuitBuilder(goal.config)
    pt = targets.add_virtual_proof_with_pis(builder, goal)
    vt = targets.add_virtual_verifier_data(builder, 2)
    out = []
    dummy.DummyProofGenerator(pt, proof, vt, vd).run_once(None, out)
    want = _Recorder()
    targets.set_proof_with_pis_target(want, pt, proof)
    targets.set_verifier_data_target(want, vt, vd)
    assert out == want.pairs

    jb = JBuilder(jgoal.config)
    jpt = jtargets.add_virtual_proof_with_pis(jb, jgoal)
    jvt = jtargets.add_virtual_verifier_data(jb, 2)
    with open(FIXTURE, "rb") as f:
        jproof = jser.deserialize_proof_with_pis(f.read(), jgoal)
    jout = []
    jdummy.DummyProofGenerator(jpt, jproof, jvt, vd).run_once(None, jout)
    assert jout == out
    # a JAX-built cyclic circuit holds a JAX proof in this generator
    with pytest.raises(NotImplementedError, match="DummyProofGenerator"):
        generator_from(jdummy.DummyProofGenerator(jpt, jproof, jvt, vd))


def test_cyclic_verifier_data_check():
    """verifier_data_from_public_inputs reads the key the fixture carries;
    check_cyclic_proof_verifier_data accepts it and rejects the key with
    any one element changed."""
    goal, _ = _goals()
    _chains()
    proof, vd = _fixture(goal)
    digest, cap = cyclic.verifier_data_from_public_inputs(
        proof.public_inputs, goal)
    assert (digest, cap) == (list(vd.circuit_digest),
                             [list(h) for h in vd.constants_sigmas_cap])
    pt = cyclic.verifier_data_from_pi_targets(list(range(29)), goal)
    assert pt.circuit_digest == [9, 10, 11, 12]
    assert pt.constants_sigmas_cap[-1] == [25, 26, 27, 28]
    cyclic.check_cyclic_proof_verifier_data(proof, vd, goal)
    start = goal.num_public_inputs - 20
    for i in (start, start + 4, goal.num_public_inputs - 1):
        bad = dataclasses.replace(proof,
                                  public_inputs=list(proof.public_inputs))
        bad.public_inputs[i] = (bad.public_inputs[i] + 1) % ORDER
        with pytest.raises(AssertionError, match="mismatch"):
            cyclic.check_cyclic_proof_verifier_data(bad, vd, goal)


def test_add_verifier_data_public_inputs_twice_raises():
    builder = CircuitBuilder(_reduced_config())
    vd = builder.add_verifier_data_public_inputs()
    assert builder.public_inputs == vd.circuit_digest + [
        t for h in vd.constants_sigmas_cap for t in h]
    with pytest.raises(AssertionError, match="only needs to be called once"):
        builder.add_verifier_data_public_inputs()


def test_goal_mismatch_raises_in_build_host():
    """A cyclic circuit laid out past its goal's degree is refused by
    build_host, not later by the commit."""
    goal, _ = _goals()
    builder = CircuitBuilder(goal.config, seed=SEED)
    _chain(builder, targets, cyclic, goal)
    with pytest.raises(AssertionError, match="does not match the goal"):
        builder.build_host(min_degree_bits=GOAL_DEGREE_BITS + 1)


def test_standard_config_goal_is_2_13():
    """At standard_recursion_config() the goal is built at 2^13 (the
    verifier needs more than 2^12) and the hash chain fits it: the degree
    `chip_smoke.py`'s cyclic-ivc phase proves at."""
    config = CircuitConfig.standard_recursion_config()
    with pytest.raises(AssertionError, match="needs degree 2"):
        cyclic.common_data_for_recursion(config, 12)
    goal = cyclic.common_data_for_recursion(config, 13)
    builder = CircuitBuilder(config, seed=SEED)
    _chain(builder, targets, cyclic, goal)
    assert goal.num_public_inputs == 9 + 4 + 4 * 16
    host = builder.build_host()
    assert host.common.same_shape(goal)


def _write_fixture():
    """A proof of the dummy circuit for the reduced goal, proved by the
    port on the CPU, whose first nine public inputs are random and whose
    last ones are its own verifier data."""
    goal = cyclic.common_data_for_recursion(_reduced_config(),
                                            GOAL_DEGREE_BITS)
    _chain(CircuitBuilder(goal.config), targets, cyclic, goal)
    data, _ = dummy.dummy_circuit_for_common(goal, device="cpu")
    values = np.random.default_rng(3).integers(0, ORDER, 9, dtype=np.uint64)
    proof = dummy.cyclic_base_proof(
        goal, data.verifier_only, dict(enumerate(int(v) for v in values)),
        device="cpu")
    data.verify(proof)
    with open(FIXTURE, "wb") as f:
        f.write(serialize_proof_with_pis(proof, goal))


if __name__ == "__main__":
    _write_fixture()
