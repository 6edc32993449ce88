"""The port's prover end to end on CPU against the JAX package: fib(100) by
the golden transcript (tests/golden/fib100_transcript.json, proof bytes
included), built by JAX and converted, and built by the port; the port's
circuit state against the JAX builder's; port proofs of dummy circuits
accepted by the JAX verifier and the port's; tampered proofs rejected.
Nothing here proves with JAX: the JAX side is the golden file, the JAX
builder and the JAX verifier."""

import copy
import json
import os

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.iop.witness import PartialWitness
from plonky2_tpu.plonk import verifier as jverifier
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig
from plonky2_tpu.recursion import dummy as jdummy
from plonky2_tpu.utils.serialization import serialize_proof_with_pis
from plonky2_tpu_torch.convert import circuit_data_from_arrays
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.get_challenges import get_challenges
from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fib100_transcript.json")


def _fib100(builder_cls, **build_kw):
    builder = builder_cls(CircuitConfig.standard_recursion_config(),
                          seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
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


def _assert_golden(data, proof):
    with open(GOLDEN) as f:
        want = json.load(f)
    got = _transcript(data, proof)
    for key in want:
        assert got[key] == want[key], f"transcript field {key!r} diverged"


@pytest.fixture(scope="module")
def jax_fib100():
    """The JAX builder's fib(100) circuit (built, never proved)."""
    return _fib100(JBuilder)


@pytest.fixture(scope="module")
def port_fib100():
    data, pw = _fib100(CircuitBuilder, device="cpu")
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
    jverifier.verify(proof, jdata.verifier_only, jdata.common)


@pytest.mark.parametrize("degree_bits", [5, 6])
def test_dummy_proof_verified_by_jax_and_port(degree_bits):
    """degree 2^6 also runs one FRI fold layer (arity 16)."""
    config = CircuitConfig.standard_recursion_config()
    data, pis = dummy_circuit(config, degree_bits, 4, device="cpu")
    proof = dummy_proof(data, pis, {0: 42})
    data.verify(proof)
    jdata, _ = jdummy.dummy_circuit(config, degree_bits, 4)
    assert list(data.verifier_only.circuit_digest) == \
        [int(x) for x in jdata.verifier_only.circuit_digest]
    jverifier.verify(proof, jdata.verifier_only, jdata.common)
    assert len(proof.proof.opening_proof.commit_phase_merkle_caps) == \
        len(jdata.common.fri_params.reduction_arity_bits)


@pytest.mark.parametrize("field", ["public_input", "wires0"])
def test_port_verifier_rejects_tampering(port_fib100, field):
    data, proof = port_fib100
    bad = copy.deepcopy(proof)
    if field == "public_input":
        bad.public_inputs[2] = (bad.public_inputs[2] + 1) % ref.ORDER
    else:
        w = bad.proof.openings.wires
        w[0] = ((w[0][0] + 1) % ref.ORDER, w[0][1])
    with pytest.raises(AssertionError):
        data.verify(bad)
