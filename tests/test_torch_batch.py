"""The port's batch prover (plonk/batch_prover.py `prove_batch`) on the CPU:
B proofs of one circuit equal, byte for byte, B serial proofs of the port
and the JAX package's `prove_batch` proofs of the same seeded circuit, with
JAX's TimingTree scope labels in JAX's order, for
the fib(100) circuit (2^3) here and tests/test_batch_prover.py's Poseidon
+ random-access circuit in tests/test_torch_batch_hash.py, at B = 2 and 3
(JAX's batch prover compiles for each B, so the two circuits are two files
for the test workers); and the batched commit's plain path
(the leaf hash over the [L, B N] columns, the B trees of one tree call a
binary run) equals B single commits under both device hashers.

The builder's random-value generators draw from one stateful rng, so each
side proves from its own identically seeded build, in the same order: the
serial proofs one after another, the batch in one call. The B = 2 batch is
held against the first two serial proofs."""

import numpy as np
import pytest
import torch

import service_circuits as sc
import timing_labels as tl
from plonky2_tpu.plonk.batch_prover import prove_batch as jprove_batch
from plonky2_tpu.utils.timing import TimingTree as JTimingTree
from plonky2_tpu.utils.serialization import (
    serialize_proof_with_pis as jserialize,
)
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field import reference as ref
from plonky2_tpu_torch.fri.oracle import PolynomialBatch, commit_batch
from plonky2_tpu_torch.hash.hashers import POSEIDON, POSEIDON2
from plonky2_tpu_torch.plonk.batch_prover import BATCH_SCOPES, prove_batch
from plonky2_tpu_torch.plonk.prover import HOST_SPANS
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis
from plonky2_tpu_torch.utils.timing import TimingTree

PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
# circuit -> (its builder over a package, the inputs of three proofs)
CIRCUITS = {
    "fib100": (lambda pkg: sc.fib(pkg, 99, seed=77), [(0, 1), (2, 5),
                                                      (3, 8)]),
    "hash_access": (lambda pkg: sc.hash_access(pkg, seed=31),
                    [(7, 0), (9, 3), (11, 2)]),
}


def serial_proofs(name: str):
    """The port's serial proofs of a circuit of CIRCUITS: (their bytes,
    their public inputs)."""
    circuit, values = CIRCUITS[name]
    builder, inputs = circuit(PORT)
    data = builder.build(device="cpu")
    proofs = [data.prove(inputs(*v)) for v in values]
    for p in proofs:
        data.verify(p)
    return ([serialize_proof_with_pis(p, data.common) for p in proofs],
            [p.public_inputs for p in proofs])


def check_batch(name: str, B: int, serial) -> None:
    """prove_batch of the first B inputs of a circuit of CIRCUITS, in the
    port and in the JAX package, against the serial proofs."""
    serial_bytes, serial_pis = serial
    circuit, values = CIRCUITS[name]
    builder, inputs = circuit(PORT)
    data = builder.build(device="cpu")
    timing = TimingTree(enabled=True)
    batch = prove_batch(data.prover_only, data.common,
                        [inputs(*v) for v in values[:B]], timing)
    jbuilder, jinputs = circuit(JAX)
    jdata = jbuilder.build()
    jtiming = JTimingTree(enabled=True)
    jbatch = jprove_batch(jdata.prover_only, jdata.common,
                          [jinputs(*v) for v in values[:B]], jtiming)
    assert len(batch) == len(jbatch) == B
    # the scopes: JAX's batch labels in order, one FRI scope a proof, and
    # the port's HOST_SPANS between them; the scopes inside round 3 and FRI
    labels = [label for depth, label, _ in timing.records if depth == 0]
    jax_labels = [label for label in labels if label not in HOST_SPANS]
    assert jax_labels == [node[0] for node in jtiming.root[2]]
    assert jax_labels == list(BATCH_SCOPES[:-1]) + [
        BATCH_SCOPES[-1].format(b=b) for b in range(B)]
    assert labels == tl.plonk_top(BATCH_SCOPES, B)
    assert tl.nested(timing) == tl.plonk_nested(data.common, BATCH_SCOPES,
                                                B)
    assert timing.counts["proofs"] == B
    for got, want, pis, jwant in zip(batch, serial_bytes, serial_pis,
                                     jbatch):
        raw = serialize_proof_with_pis(got, data.common)
        assert got.public_inputs == pis
        assert raw == want
        assert raw == jserialize(jwant, jdata.common)
        data.verify(got)
    assert len({serialize_proof_with_pis(p, data.common)
                for p in batch}) == B


@pytest.fixture(scope="module")
def fib_serial():
    return serial_proofs("fib100")


@pytest.mark.parametrize("B", [2, 3])
def test_prove_batch_fib100_equals_serial_and_jax(fib_serial, B):
    check_batch("fib100", B, fib_serial)


def test_prove_batch_refuses_zk_and_host_hashers():
    from plonky2_tpu_torch.hash.hashers import KeccakGoldilocksConfig
    builder, inputs = sc.fib(PORT, 3, seed=1)
    data = builder.build(device="cpu", gc=KeccakGoldilocksConfig)
    with pytest.raises(AssertionError, match="device"):
        prove_batch(data.prover_only, data.common, [inputs(0, 1)])
    builder, inputs = sc.fib(PORT, 3, seed=1,
                             config_name="standard_recursion_zk_config")
    common = builder.build_host().common
    with pytest.raises(AssertionError, match="zk"):
        prove_batch(None, common, [inputs(0, 1)])


@pytest.mark.parametrize("hasher", [POSEIDON, POSEIDON2],
                         ids=["poseidon", "poseidon2"])
@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_batched_commit_equals_single_commits(hasher, B):
    """commit_batch of coefficients [num, B, n] (its leaf hash over the
    [num, B N] columns, one tree call a binary run of B) against B calls of
    from_coeffs: coefficients, leaves, every layer and the cap."""
    rng = np.random.default_rng(B)
    num, n, rate_bits, cap_height = 9, 1 << 4, 3, 2
    coeffs = gl.from_u64(rng.integers(0, ref.ORDER, size=(num, B, n),
                                      dtype=np.uint64), "cpu")
    got = commit_batch(coeffs, rate_bits, cap_height, hasher)
    assert got.coeffs.shape == (num, B, n)
    for b, batch in enumerate(got.batches):
        want = PolynomialBatch.from_coeffs(coeffs[:, b].contiguous(),
                                           rate_bits, cap_height, hasher)
        assert torch.equal(batch.polynomials, want.polynomials)
        assert torch.equal(batch.merkle_tree.leaves, want.merkle_tree.leaves)
        assert len(batch.merkle_tree.layers) == len(want.merkle_tree.layers)
        for a, w in zip(batch.merkle_tree.layers, want.merkle_tree.layers):
            assert torch.equal(a, w)
        assert batch.merkle_tree.cap_digests() == \
            want.merkle_tree.cap_digests()
        idx = [0, 5, n * 8 - 1]
        assert np.array_equal(batch.merkle_tree.prove_batch(idx),
                              want.merkle_tree.prove_batch(idx))
    lde = got.natural_lde(2)
    for b, batch in enumerate(got.batches):
        assert torch.equal(lde[:, b], batch.natural_lde(2))
