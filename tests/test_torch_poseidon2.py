"""The port's Poseidon2 (kernels K6/K7 through their plain versions on CPU)
against the JAX package: the permutation against JAX `poseidon2_permute` and
the host oracle, edge values included; the leaf sponge against JAX
`hash_no_pad_lanes`; compress against JAX `compress_lanes` and the host
two_to_one; a Poseidon2 Merkle cap and paths against the JAX MerkleTree.
Inputs are made by numpy from a seed. Tolerance: exact.

The JAX lanes functions run their CPU path (the Pallas kernels run only on a
TPU or in interpret mode, which tests/test_pallas_poseidon2.py skips here)."""

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.hash import hashers as jhashers
from plonky2_tpu.hash import poseidon2 as jps2
from plonky2_tpu.hash.merkle import MerkleTree as JMerkleTree
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon2 as ps2
from plonky2_tpu_torch.hash.hashers import POSEIDON2
from plonky2_tpu_torch.hash.merkle import (
    MerkleTree, verify_merkle_proof_oracle,
)

RNG = np.random.default_rng(21)
EDGES = [0, 1, ref.ORDER - 1, (1 << 32) - 1, 1 << 32]


def _rand(*shape):
    return RNG.integers(0, ref.ORDER, size=shape, dtype=np.uint64)


def _states():
    """Random states, then states built from the edge values."""
    edge = np.asarray([[EDGES[(i + j) % len(EDGES)] for j in range(12)]
                       for i in range(len(EDGES))]
                      + [[v] * 12 for v in EDGES], dtype=np.uint64)
    return np.concatenate([_rand(32, 12), edge])


def test_permute_plain_vs_jax_and_oracle():
    x = _states()
    got = gl.to_u64(ps2.permute(gl.from_u64(x, "cpu")))
    np.testing.assert_array_equal(
        got, jps2.poseidon2_permute(GF.from_u64(x)).to_u64())
    for row, out in zip(x, got):
        inp = [int(v) for v in row]
        assert [int(v) for v in out] == jps2.poseidon2_oracle(inp)
        assert ps2.poseidon2_oracle(inp) == jps2.poseidon2_oracle(inp)
        assert ps2.permute_host(inp) == jps2.poseidon2_oracle(inp)
    np.testing.assert_array_equal(ps2.permute_many_host(x), got)


@pytest.mark.parametrize("L", [5, 8, 9, 135])
def test_leaf_sponge_vs_jax(L):
    x = _rand(L, 256)
    got = gl.to_u64(ps2.hash_leaves(gl.from_u64(x, "cpu")))       # [256, 4]
    want = jps2.hash_no_pad_lanes(GF.from_u64(x)).to_u64()        # [4, 256]
    np.testing.assert_array_equal(got, want.T)
    col = [int(v) for v in x[:, 3]]
    assert list(got[3]) == jps2.hash_no_pad_oracle(col)
    assert list(POSEIDON2.hash_no_pad_oracle(col)) == \
        jps2.hash_no_pad_oracle(col)


def test_compress_vs_jax():
    left, right = _rand(64, 4), _rand(64, 4)
    got = gl.to_u64(ps2.compress(gl.from_u64(left, "cpu"),
                                 gl.from_u64(right, "cpu")))
    want = jps2.compress_lanes(GF.from_u64(left.T.copy()),
                               GF.from_u64(right.T.copy())).to_u64()
    np.testing.assert_array_equal(got, want.T)
    for a, b, g in zip(left[:4], right[:4], got[:4]):
        a, b = [int(v) for v in a], [int(v) for v in b]
        assert POSEIDON2.two_to_one_oracle(a, b) == tuple(int(v) for v in g)
        assert POSEIDON2.two_to_one_oracle(a, b) == \
            jhashers.POSEIDON2.two_to_one_oracle(a, b)


def test_merkle_cap_vs_jax():
    lg_n, cap_height = 6, 4
    leaves = _rand(1 << lg_n, 20)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height, POSEIDON2)
    jtree = JMerkleTree(GF.from_u64(leaves), cap_height,
                        hasher=jhashers.POSEIDON2)
    assert tree.cap_digests() == \
        [tuple(int(x) for x in d) for d in jtree.cap_digests()]
    idx = list(range(1 << lg_n))
    proofs = tree.prove_batch(idx)
    for i in idx:
        np.testing.assert_array_equal(proofs[i], jtree.prove(i))
    leaf = [int(v) for v in leaves[5]]
    assert verify_merkle_proof_oracle(leaf, 5, tree.cap_digests(), proofs[5],
                                      POSEIDON2)
    leaf[0] = (leaf[0] + 1) % ref.ORDER
    assert not verify_merkle_proof_oracle(leaf, 5, tree.cap_digests(),
                                          proofs[5], POSEIDON2)
