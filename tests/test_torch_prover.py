"""The port's prover end to end on CPU against the JAX package: fib(100) by
the golden transcript (tests/golden/fib100_transcript.json, proof bytes
included), built by JAX and converted, and built by the port; fib(21) under
Poseidon2GoldilocksConfig by its golden transcript; the port's circuit
state against the JAX builder's, field by field; port proofs of dummy
circuits accepted by the JAX verifier (read back by the JAX package from the
port's proof bytes) and by the port's; tampered proofs rejected. Nothing
here proves with JAX: the JAX side is the golden files, the JAX builder,
deserializer and verifier. The two packages share no class: the port is
driven with its own PartialWitness and CircuitConfig, and proofs cross over
as bytes."""

import copy
import json
import os

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.hash import hashers as jhashers
from plonky2_tpu.plonk import verifier as jverifier
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.recursion import dummy as jdummy
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.convert import circuit_data_from_arrays, common_from
from plonky2_tpu_torch.hash.hashers import CONFIGS
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.get_challenges import get_challenges
from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "fib100_transcript.json")
GOLDEN_P2 = os.path.join(GOLDEN_DIR,
                         "fib21_Poseidon2GoldilocksConfig_transcript.json")
P2 = "Poseidon2GoldilocksConfig"


def _fib(builder_cls, config_cls, steps=99, **build_kw):
    """The seeded fib circuit of tests/golden_common.py; returns the built
    data and the port's witness of its two inputs."""
    builder = builder_cls(config_cls.standard_recursion_config(), seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(steps):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    return builder.build(**build_kw), pw


def _transcript(data, proof):
    common = data.common
    pi_hash = common.gc.hash_public_inputs(proof.public_inputs)
    ch = get_challenges(proof, pi_hash, data.verifier_only.circuit_digest,
                        common)
    fc = ch.fri_challenges
    return {
        "circuit_digest": [int(x) for x in data.verifier_only.circuit_digest],
        "public_inputs": [int(x) for x in proof.public_inputs],
        "pi_hash": list(pi_hash),
        "betas": list(ch.plonk_betas), "gammas": list(ch.plonk_gammas),
        "alphas": list(ch.plonk_alphas), "zeta": list(ch.plonk_zeta),
        "fri_alpha": list(fc.fri_alpha),
        "fri_betas": [list(b) for b in fc.fri_betas],
        "fri_pow_response": fc.fri_pow_response,
        "fri_query_indices": list(fc.fri_query_indices),
        "pow_witness": int(proof.proof.opening_proof.pow_witness),
        "proof_hex": serialize_proof_with_pis(proof, common).hex(),
    }


def _assert_golden(data, proof, path=GOLDEN):
    with open(path) as f:
        want = json.load(f)
    got = _transcript(data, proof)
    assert len(want) == 13
    for key in want:
        assert got[key] == want[key], f"transcript field {key!r} diverged"


def _jax_verify(proof, data, jdata):
    """The JAX verifier on the JAX package's reading of the port's bytes."""
    raw = serialize_proof_with_pis(proof, data.common)
    jproof = jser.deserialize_proof_with_pis(raw, jdata.common)
    assert jser.serialize_proof_with_pis(jproof, jdata.common) == raw
    jverifier.verify(jproof, jdata.verifier_only, jdata.common)


def _tamper(proof, field):
    bad = copy.deepcopy(proof)
    if field == "public_input":
        bad.public_inputs[2] = (bad.public_inputs[2] + 1) % ref.ORDER
    else:
        w = bad.proof.openings.wires
        w[0] = ((w[0][0] + 1) % ref.ORDER, w[0][1])
    return bad


@pytest.fixture(scope="module")
def jax_fib100():
    """The JAX builder's fib(100) circuit (built, never proved)."""
    return _fib(JBuilder, JCircuitConfig)


@pytest.fixture(scope="module")
def port_fib100():
    data, pw = _fib(CircuitBuilder, CircuitConfig, device="cpu")
    return data, data.prove(pw)


@pytest.fixture(scope="module")
def jax_fib21_p2():
    return _fib(JBuilder, JCircuitConfig, steps=20,
                gc=jhashers.CONFIGS[P2])[0]


@pytest.fixture(scope="module")
def port_fib21_p2():
    data, pw = _fib(CircuitBuilder, CircuitConfig, steps=20, device="cpu",
                    gc=CONFIGS[P2])
    return data, data.prove(pw)


def test_jax_built_fib100_proved_by_port_matches_golden(jax_fib100):
    jdata, pw = jax_fib100
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
    proof = data.prove(pw)
    _assert_golden(data, proof)
    data.verify(proof)


def test_port_builder_matches_jax_builder(jax_fib100, port_fib100):
    jdata, _ = jax_fib100
    data, _ = port_fib100
    assert common_from(jdata.common) == data.common
    assert list(data.verifier_only.circuit_digest) == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    assert data.verifier_only.constants_sigmas_cap == \
        [tuple(int(x) for x in d)
         for d in jdata.verifier_only.constants_sigmas_cap]
    np.testing.assert_array_equal(data.prover_only.sigmas,
                                  jdata.prover_only.sigmas)
    np.testing.assert_array_equal(data.prover_only.representative_map,
                                  jdata.prover_only.representative_map)
    assert [g.id() for g in data.common.gates] == \
        [g.id() for g in jdata.common.gates]


def test_port_fib100_matches_golden_and_jax_verifies(jax_fib100,
                                                     port_fib100):
    jdata, _ = jax_fib100
    data, proof = port_fib100
    _assert_golden(data, proof)
    _jax_verify(proof, data, jdata)


def test_port_fib21_poseidon2_matches_golden(jax_fib21_p2, port_fib21_p2):
    data, proof = port_fib21_p2
    _assert_golden(data, proof, GOLDEN_P2)
    assert common_from(jax_fib21_p2.common) == data.common
    data.verify(proof)


def test_jax_verifies_port_poseidon2_proof(jax_fib21_p2, port_fib21_p2):
    data, proof = port_fib21_p2
    _jax_verify(proof, data, jax_fib21_p2)


@pytest.mark.parametrize("degree_bits", [5, 6])
def test_dummy_proof_verified_by_jax_and_port(degree_bits):
    """degree 2^6 also runs one FRI fold layer (arity 16)."""
    data, pis = dummy_circuit(CircuitConfig.standard_recursion_config(),
                              degree_bits, 4, device="cpu")
    proof = dummy_proof(data, pis, {0: 42})
    data.verify(proof)
    jdata, _ = jdummy.dummy_circuit(JCircuitConfig.standard_recursion_config(),
                                    degree_bits, 4)
    assert list(data.verifier_only.circuit_digest) == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    _jax_verify(proof, data, jdata)
    assert len(proof.proof.opening_proof.commit_phase_merkle_caps) == \
        len(jdata.common.fri_params.reduction_arity_bits)


def test_dummy_poseidon2_proof_verified_by_jax_and_port():
    """The dummy circuit of the chip run under Poseidon2, at degree 2^6:
    Poseidon2 commits, one FRI fold layer and the plain Poseidon2 PoW."""
    data, pis = dummy_circuit(CircuitConfig.standard_recursion_config(), 6,
                              4, device="cpu", gc=CONFIGS[P2])
    proof = dummy_proof(data, pis, {0: 42})
    data.verify(proof)
    builder = JBuilder(JCircuitConfig.standard_recursion_config())
    builder.register_public_inputs(builder.add_virtual_targets(4))
    jdata = builder.build(min_degree_bits=6, gc=jhashers.CONFIGS[P2])
    assert list(data.verifier_only.circuit_digest) == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    _jax_verify(proof, data, jdata)


@pytest.mark.parametrize("field", ["public_input", "wires0"])
def test_port_verifier_rejects_tampering(port_fib100, field):
    data, proof = port_fib100
    with pytest.raises(AssertionError):
        data.verify(_tamper(proof, field))


@pytest.mark.parametrize("field", ["public_input", "wires0"])
def test_port_verifier_rejects_poseidon2_tampering(port_fib21_p2, field):
    data, proof = port_fib21_p2
    with pytest.raises(AssertionError):
        data.verify(_tamper(proof, field))
