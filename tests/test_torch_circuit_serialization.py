"""Circuit-data checkpoint and load in the port
(utils/circuit_serialization.py and the splits of plonk/circuit_data.py),
mirroring tests/test_circuit_serialization.py on the CPU: each split
round-trips; a proof from reloaded data equals the fresh circuit's bytes
when the load is handed the builder's random stream; the reloaded
CommonCircuitData equals the JAX package's for the same circuit (through
convert.py) field by field; MockCircuitData's witness equals the prover's
and JAX's; a blob naming a class outside the port is refused."""

import io
import json
import zipfile

import numpy as np
import pytest

import service_circuits as sc
from plonky2_tpu_torch.convert import common_from
from plonky2_tpu_torch.hash.hashers import Poseidon2GoldilocksConfig
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.utils import circuit_serialization as cs
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis

PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
SEED = 1234


def _circuit(pkg):
    """tests/test_circuit_serialization.py's circuit: fib(21) and the
    inverse of its last term (one more generator class), seeded."""
    builder, inputs = sc.fib(pkg, 20, seed=SEED)
    builder.inverse(builder.public_inputs[-1])
    return builder, inputs


@pytest.fixture(scope="module")
def circuit():
    builder, inputs = _circuit(PORT)
    return builder.build(device="cpu"), inputs(0, 1)


def _same_common(a, b) -> None:
    assert a.same_shape(b)
    assert a.config == b.config and a.fri_params == b.fri_params
    assert [g.id() for g in a.gates] == [g.id() for g in b.gates]
    assert a.selectors_info == b.selectors_info
    assert a.k_is == b.k_is and a.gc.name == b.gc.name
    for key in ("quotient_degree_factor", "num_gate_constraints",
                "num_constants", "num_public_inputs",
                "num_partial_products"):
        assert getattr(a, key) == getattr(b, key), key


def test_circuit_data_roundtrip_build_save_reload_prove_verify(circuit):
    data, pw = circuit
    restored = cs.deserialize_circuit_data(
        cs.serialize_circuit_data(data), device="cpu",
        rng=np.random.default_rng(SEED))
    _same_common(restored.common, data.common)
    assert restored.verifier_only.circuit_digest == \
        data.verifier_only.circuit_digest
    assert (restored.prover_only.constants_sigmas_commitment.merkle_tree
            .cap_digests()
            == data.prover_only.constants_sigmas_commitment.merkle_tree
            .cap_digests())
    # a fresh build from the same seed draws what the load is handed
    fresh, inputs = _circuit(PORT)
    fresh = fresh.build(device="cpu")
    want = fresh.prove(inputs(0, 1))
    proof = restored.prove(pw)
    assert proof.public_inputs[2] == 10946
    assert serialize_proof_with_pis(proof, restored.common) == \
        serialize_proof_with_pis(want, fresh.common)
    restored.verify(proof)
    data.verify(proof)


def test_common_circuit_data_roundtrip_equals_jax(circuit):
    data, _ = circuit
    common = cs.deserialize_common_circuit_data(
        cs.serialize_common_circuit_data(data.common))
    _same_common(common, data.common)
    jcommon = _circuit(JAX)[0].build().common
    _same_common(common, common_from(jcommon))


def test_prover_verifier_splits_roundtrip(circuit):
    data, pw = circuit
    prover = cs.deserialize_prover_circuit_data(
        cs.serialize_prover_circuit_data(data.prover_data()), device="cpu")
    verifier = cs.deserialize_verifier_circuit_data(
        cs.serialize_verifier_circuit_data(data.verifier_data()))
    assert verifier.verifier_only.constants_sigmas_cap == \
        data.verifier_only.constants_sigmas_cap
    proof = prover.prove(pw)
    verifier.verify(proof)
    data.verify(proof)
    verifier.verify_compressed(data.compress(proof))


def test_mock_circuit_data_witness_equals_prover_and_jax():
    builder, inputs = _circuit(PORT)
    data = builder.build(device="cpu")
    mock = cs.deserialize_circuit_data(
        cs.serialize_circuit_data(data), device="cpu",
        rng=np.random.default_rng(SEED)).mock()
    witness = mock.generate_witness(inputs(0, 1))
    full = witness.full_witness()
    assert [witness.get(t) for t in data.prover_only.public_inputs][2] == \
        10946
    want = generate_partial_witness(inputs(0, 1), data.prover_only,
                                    data.common)
    assert np.array_equal(full, want.full_witness())
    jbuilder, jinputs = _circuit(JAX)
    jwitness = jbuilder.build().mock().generate_witness(jinputs(0, 1))
    assert np.array_equal(full, np.asarray(jwitness.full_witness()))


def test_poseidon2_circuit_roundtrip():
    builder, inputs = sc.fib(PORT, 20, seed=SEED)
    data = builder.build(device="cpu", gc=Poseidon2GoldilocksConfig)
    restored = cs.deserialize_circuit_data(cs.serialize_circuit_data(data),
                                           device="cpu")
    assert restored.common.gc.name == "Poseidon2GoldilocksConfig"
    assert restored.verifier_only.constants_sigmas_cap == \
        data.verifier_only.constants_sigmas_cap
    data.verify(restored.prove(inputs(0, 1)))


def test_load_refuses_classes_outside_the_port(circuit):
    data, _ = circuit
    blob = cs.serialize_common_circuit_data(data.common)
    z = zipfile.ZipFile(io.BytesIO(blob))
    structure = json.loads(z.read("structure.json"))
    structure["common"]["gates"][0]["__obj__"] = "subprocess:Popen"
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as w:
        w.writestr("structure.json", json.dumps(structure))
        for name in z.namelist():
            if name != "structure.json":
                w.writestr(name, z.read(name))
    with pytest.raises(ValueError, match="refusing"):
        cs.deserialize_common_circuit_data(out.getvalue())
