"""Compressed proofs and verifier data in the port (hash/path_compression.py,
fri/compressed.py, plonk/compressed_proof.py, utils/serialization.py) on the
CPU against the JAX package: the port's compressed fib(100) proof equals
JAX's `data.compress` of the same proof field by field, and its bytes equal
JAX's `serialize_compressed_proof_with_pis`; each package decompresses the
other's bytes back to the proof; a tampered compressed proof is refused;
the verifier data's bytes equal JAX's. A Keccak proof (byte digests)
round-trips through the port alone (the JAX package writes its compressed
digests as field elements)."""

import copy

import numpy as np
import pytest

import service_circuits as sc
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.hash.hashers import KeccakGoldilocksConfig
from plonky2_tpu_torch.utils import serialization as ser

PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"


@pytest.fixture(scope="module")
def fib():
    """(port data, its proof, JAX's data of the same circuit, the proof
    read by JAX from the port's bytes)."""
    builder, inputs = sc.fib(PORT, 99, seed=1234)
    data = builder.build(device="cpu")
    proof = data.prove(inputs(0, 1))
    jdata = sc.fib(JAX, 99, seed=1234)[0].build()
    raw = ser.serialize_proof_with_pis(proof, data.common)
    return data, proof, jdata, jser.deserialize_proof_with_pis(
        raw, jdata.common)


def _norm(x):
    """Digests, rows and pairs as nested lists of ints."""
    if isinstance(x, (bytes, bytearray)):
        return list(x)
    if isinstance(x, np.ndarray):
        return _norm(x.tolist())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return int(x)


def _fields(c) -> dict:
    p, fp = c.proof, c.proof.opening_proof
    q = fp.query_round_proofs
    o = p.openings
    return {
        "caps": _norm([p.wires_cap, p.plonk_zs_partial_products_cap,
                       p.quotient_polys_cap]),
        "openings": _norm([o.constants, o.plonk_sigmas, o.wires, o.plonk_zs,
                           o.plonk_zs_next, o.partial_products,
                           o.quotient_polys]),
        "commit_caps": _norm(fp.commit_phase_merkle_caps),
        "indices": _norm(q.indices),
        "initial": {k: _norm(v.evals_proofs)
                    for k, v in q.initial_trees_proofs.items()},
        "steps": [{k: _norm([s.evals, s.merkle_proof])
                   for k, s in level.items()} for level in q.steps],
        "final_poly": _norm(fp.final_poly),
        "pow_witness": int(fp.pow_witness),
        "public_inputs": _norm(c.public_inputs),
    }


def test_compressed_proof_equals_jax_field_by_field(fib):
    data, proof, jdata, jproof = fib
    got, want = _fields(data.compress(proof)), _fields(jdata.compress(jproof))
    assert list(got) == list(want)
    for key in got:
        assert got[key] == want[key], key
    # repeated query indices share one initial-tree proof, and siblings
    # shrink
    q = data.compress(proof).proof.opening_proof.query_round_proofs
    assert len(q.initial_trees_proofs) <= len(q.indices)
    full = sum(len(r.initial_trees_proof.evals_proofs[0][1])
               for r in proof.proof.opening_proof.query_round_proofs)
    assert sum(len(p.evals_proofs[0][1])
               for p in q.initial_trees_proofs.values()) < full


def test_compressed_bytes_equal_jax(fib):
    data, proof, jdata, jproof = fib
    raw = ser.serialize_compressed_proof_with_pis(data.compress(proof),
                                                  data.common)
    assert raw == jser.serialize_compressed_proof_with_pis(
        jdata.compress(jproof), jdata.common)
    assert len(raw) < len(ser.serialize_proof_with_pis(proof, data.common))


def test_port_decompresses_jax_bytes(fib):
    data, proof, jdata, jproof = fib
    raw = jser.serialize_compressed_proof_with_pis(jdata.compress(jproof),
                                                   jdata.common)
    compressed = ser.deserialize_compressed_proof_with_pis(raw, data.common)
    assert ser.serialize_compressed_proof_with_pis(compressed,
                                                   data.common) == raw
    restored = data.decompress(compressed)
    assert ser.serialize_proof_with_pis(restored, data.common) == \
        ser.serialize_proof_with_pis(proof, data.common)
    data.verify_compressed(compressed)
    data.verifier_data().verify_compressed(compressed)


def test_jax_decompresses_port_bytes(fib):
    data, proof, jdata, _ = fib
    raw = ser.serialize_compressed_proof_with_pis(data.compress(proof),
                                                  data.common)
    jcompressed = jser.deserialize_compressed_proof_with_pis(raw,
                                                             jdata.common)
    restored = jdata.decompress(jcompressed)
    assert jser.serialize_proof_with_pis(restored, jdata.common) == \
        ser.serialize_proof_with_pis(proof, data.common)
    jdata.verify(restored)


def test_compressed_proof_rejects_tampering(fib):
    data, proof, _, _ = fib
    compressed = data.compress(proof)
    bad = copy.deepcopy(compressed)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % (2**64 - 2**32 + 1)
    with pytest.raises((AssertionError, KeyError)):
        data.verify_compressed(bad)
    bad = copy.deepcopy(compressed)
    initial = bad.proof.opening_proof.query_round_proofs.initial_trees_proofs
    evals, path = next(iter(initial.values())).evals_proofs[1]
    evals[0] = (int(evals[0]) + 1) % (2**64 - 2**32 + 1)
    with pytest.raises(AssertionError):
        data.verify_compressed(bad)


def test_verifier_data_bytes_equal_jax(fib):
    data, _, jdata, _ = fib
    raw = ser.serialize_verifier_data(data.verifier_only)
    assert raw == jser.serialize_verifier_data(jdata.verifier_only)
    back = ser.deserialize_verifier_data(raw)
    assert back.constants_sigmas_cap == data.verifier_only.constants_sigmas_cap
    assert back.circuit_digest == data.verifier_only.circuit_digest


def test_keccak_compressed_proof_round_trips():
    """Byte digests (25 bytes) in caps and compressed paths."""
    builder, inputs = sc.fib(PORT, 20, seed=1234)
    data = builder.build(device="cpu", gc=KeccakGoldilocksConfig)
    proof = data.prove(inputs(0, 1))
    raw = ser.serialize_compressed_proof_with_pis(data.compress(proof),
                                                  data.common)
    compressed = ser.deserialize_compressed_proof_with_pis(raw, data.common)
    assert ser.serialize_compressed_proof_with_pis(compressed,
                                                   data.common) == raw
    assert ser.serialize_proof_with_pis(data.decompress(compressed),
                                        data.common) == \
        ser.serialize_proof_with_pis(proof, data.common)
    data.verify_compressed(compressed)
    vd = ser.deserialize_verifier_data(
        ser.serialize_verifier_data(data.verifier_only),
        data.common.gc.hasher)
    assert vd.circuit_digest == data.verifier_only.circuit_digest
