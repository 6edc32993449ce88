"""Zero knowledge in the port (blinding rows in plonk/circuit_builder.py,
salted oracles in fri/oracle.py, `prove(..., rng=...)`) and the FRI
reduction strategies, on the CPU against the JAX package:
- the `fixed`, `constant_arity` and `min_size` arity bits equal JAX's over a
  grid of degree bits, rate bits, cap heights and query counts;
- the small ZK fib of tests/service_circuits.py (`zk_fib`: 2 query rounds,
  2^9 rows after blinding) lays out as JAX's: degree, gates, the blinding
  generators, the copy constraints (sigmas, representative map) and the
  common data;
- a port proof with the salts of `ZK_SALT_SEED` equals, byte for byte,
  tests/golden/zk_fib_small.bin (made by JAX with the same salt stream,
  scripts/jax_zk_golden.py); JAX's verifier accepts the port's proof and
  the port's verifier accepts JAX's golden proof;
- unseeded proofs differ and verify, tampered ones are refused, and the
  proof round-trips through its bytes and its compressed form.

The JAX package's proof reader omits the salt of a hiding proof's initial
trees, so the JAX side reads the port's bytes with `_jax_read` below, the
same reader with the reference's salted leaf widths. XLA:CPU compiles the
JAX commit of a 2^9 circuit for minutes, so the JAX build here takes its
constants' cap from tests/golden/zk_fib_small_verifier.bin, the verifier
data scripts/jax_zk_golden.py recorded from JAX's own commit; everything
else of the JAX circuit (layout, sigmas, digest, common data) is built."""

import contextlib
import copy
import os
import types

import numpy as np
import pytest
import torch

import service_circuits as sc
from plonky2_tpu.fri.config import FriReductionStrategy as JStrategy
from plonky2_tpu.plonk import circuit_builder as jcircuit_builder
from plonky2_tpu.plonk import verifier as jverifier
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.convert import common_from
from plonky2_tpu_torch.fri.config import FriReductionStrategy
from plonky2_tpu_torch.iop.generator import RandomValueGenerator
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.utils import serialization as ser

PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "zk_fib_small.bin")
GOLDEN_VD = os.path.join(os.path.dirname(__file__), "golden",
                         "zk_fib_small_verifier.bin")
P = 2**64 - 2**32 + 1

STRATEGIES = {
    "fixed": dict(kind="fixed", fixed=(3, 2, 1)),
    "constant": dict(kind="constant_arity", arity_bits=4,
                     final_poly_bits=5),
    "constant3": dict(kind="constant_arity", arity_bits=3,
                      final_poly_bits=3),
    "min_size": dict(kind="min_size"),
    "min_size3": dict(kind="min_size", max_arity_bits=3),
}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("degree_bits", [4, 9, 13, 16])
@pytest.mark.parametrize("rate_bits,cap_height", [(1, 0), (3, 4), (2, 2)])
@pytest.mark.parametrize("num_queries", [1, 28])
def test_reduction_arity_bits_equal_jax(strategy, degree_bits, rate_bits,
                                        cap_height, num_queries):
    kw = STRATEGIES[strategy]
    args = (degree_bits, rate_bits, cap_height, num_queries)
    assert FriReductionStrategy(**kw).reduction_arity_bits(*args) == \
        JStrategy(**kw).reduction_arity_bits(*args)


def _jax_read(raw: bytes, common):
    """JAX's deserialize_proof_with_pis with the reference's initial-tree
    leaf widths: SALT_SIZE more on each blinded oracle of a hiding proof."""
    from plonky2_tpu.plonk.proof import (
        OpeningSet, Proof, ProofWithPublicInputs,
    )
    buf = jser.Buffer(raw)
    hasher = common.gc.hasher
    ch = common.config.fri_config.cap_height
    caps = [buf.read_cap(ch, hasher) for _ in range(3)]
    o = OpeningSet(
        constants=buf.read_ext_vec(len(common.constants_range)),
        plonk_sigmas=buf.read_ext_vec(len(common.sigmas_range)),
        wires=buf.read_ext_vec(common.config.num_wires),
        plonk_zs=buf.read_ext_vec(len(common.zs_range)),
        plonk_zs_next=buf.read_ext_vec(len(common.zs_range)),
        partial_products=buf.read_ext_vec(len(common.partial_products_range)),
        quotient_polys=buf.read_ext_vec(common.num_quotient_polys))
    salt = 4 if common.fri_params.hiding else 0
    widths = [o_.num_polys + (salt if o_.blinding else 0)
              for o_ in common._fri_oracles()]
    opening_proof = jser._read_fri_proof(buf, common.fri_params, widths,
                                         hasher)
    pis = buf.read_field_vec(common.num_public_inputs)
    return ProofWithPublicInputs(
        proof=Proof(wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1],
                    quotient_polys_cap=caps[2], openings=o,
                    opening_proof=opening_proof),
        public_inputs=pis)


@contextlib.contextmanager
def _one_thread():
    """torch on one thread for the port's CPU proves: the test workers share
    the cores, and ops on the 2^12-point LDE split over all of them run
    many times slower under that contention than on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class _RecordedCommit:
    """Stands in for the JAX builder's PolynomialBatch: its commit of the
    constants and sigmas yields the cap JAX recorded for this circuit."""

    def __init__(self, cap):
        self.cap = cap

    def from_values(self, *args, **kwargs):
        tree = types.SimpleNamespace(cap_digests=lambda: list(self.cap))
        return types.SimpleNamespace(merkle_tree=tree)


@pytest.fixture(scope="module")
def zk():
    """(port builder, port data, its seeded proof, JAX builder, JAX
    data)."""
    builder, inputs = sc.zk_fib(PORT)
    with _one_thread():
        data = builder.build(device="cpu")
        proof = data.prove(inputs(*sc.ZK_INPUTS),
                           rng=np.random.default_rng(sc.ZK_SALT_SEED))
    with open(GOLDEN_VD, "rb") as f:
        cap = jser.deserialize_verifier_data(f.read()).constants_sigmas_cap
    jbuilder = sc.zk_fib(JAX)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcircuit_builder, "PolynomialBatch", _RecordedCommit(cap))
        jdata = jbuilder.build()
    return builder, data, proof, jbuilder, jdata


def test_blinding_layout_equals_jax(zk):
    builder, data, _, jbuilder, jdata = zk
    common = data.common
    assert common.degree_bits == jdata.common.degree_bits == 9
    assert common.fri_params.hiding and jdata.common.fri_params.hiding
    assert len(builder.gate_instances) == len(jbuilder.gate_instances)
    assert [g.id() for g, _ in builder.gate_instances] == \
        [g.id() for g, _ in jbuilder.gate_instances]
    assert builder.copy_constraints == jbuilder.copy_constraints
    random = [g.target for g in data.prover_only.generators
              if isinstance(g, RandomValueGenerator)]
    jrandom = [g.target for g in jdata.prover_only.generators
               if type(g).__name__ == "RandomValueGenerator"]
    assert random == jrandom
    assert len(random) > 139 * 100
    assert np.array_equal(data.prover_only.sigmas, jdata.prover_only.sigmas)
    assert np.array_equal(data.prover_only.representative_map,
                          jdata.prover_only.representative_map)
    assert common.same_shape(common_from(jdata.common))
    assert data.verifier_only.circuit_digest == \
        tuple(jdata.verifier_only.circuit_digest)


def test_seeded_zk_proof_equals_jax_golden(zk):
    _, data, proof, _, jdata = zk
    with open(GOLDEN, "rb") as f:
        golden = f.read()
    assert ser.serialize_proof_with_pis(proof, data.common) == golden
    data.verify(proof)
    with open(GOLDEN_VD, "rb") as f:
        vd = f.read()
    assert ser.serialize_verifier_data(data.verifier_only) == vd
    assert jser.serialize_verifier_data(jdata.verifier_only) == vd


def test_each_verifier_accepts_the_others_zk_proof(zk):
    _, data, proof, _, jdata = zk
    raw = ser.serialize_proof_with_pis(proof, data.common)
    jproof = _jax_read(raw, jdata.common)
    assert jser.serialize_proof_with_pis(jproof, jdata.common) == raw
    jverifier.verify(jproof, jdata.verifier_only, jdata.common)
    with open(GOLDEN, "rb") as f:
        golden = ser.deserialize_proof_with_pis(f.read(), data.common)
    data.verify(golden)


def test_zk_proofs_differ_and_tampering_is_refused(zk):
    _, data, proof, _, _ = zk
    a, b = data.prover_only.public_inputs[:2]       # the fib's two inputs
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    with _one_thread():
        other = data.prove(pw)
    data.verify(other)
    assert other.proof.wires_cap != proof.proof.wires_cap
    assert other.public_inputs == proof.public_inputs
    bad = copy.deepcopy(proof)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    with pytest.raises(AssertionError):
        data.verify(bad)
    bad = copy.deepcopy(proof)
    evals, path = bad.proof.opening_proof.query_round_proofs[0] \
        .initial_trees_proof.evals_proofs[1]
    evals[-1] = (int(evals[-1]) + 1) % P        # a salt element
    with pytest.raises(AssertionError):
        data.verify(bad)


def test_zk_proof_round_trips_bytes_and_compression(zk):
    _, data, proof, _, _ = zk
    raw = ser.serialize_proof_with_pis(proof, data.common)
    back = ser.deserialize_proof_with_pis(raw, data.common)
    assert ser.serialize_proof_with_pis(back, data.common) == raw
    evals = back.proof.opening_proof.query_round_proofs[0] \
        .initial_trees_proof.evals_proofs
    assert [len(e) for e, _ in evals] == \
        [data.common.num_preprocessed_polys, 135 + 4,
         data.common.num_zs_partial_products_polys + 4,
         data.common.num_quotient_polys + 4]
    craw = ser.serialize_compressed_proof_with_pis(data.compress(proof),
                                                   data.common)
    compressed = ser.deserialize_compressed_proof_with_pis(craw, data.common)
    assert ser.serialize_proof_with_pis(data.decompress(compressed),
                                        data.common) == raw
    data.verify_compressed(compressed)
