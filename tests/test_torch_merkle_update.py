"""The okx fork's mutable Merkle trees in the port (`hash/merkle.py`
`MerkleTree.prove`, `change_leaf_and_update`,
`change_leaves_in_range_and_update`; reference merkle_tree.rs:638-805)
against the JAX package's `MerkleTree` on the same numpy-seeded leaves
(tests/test_merkle.py:27,59), bit for bit: every layer and every leaf's
path after each update. JAX updates Poseidon trees only; under the other
hashers the updated tree is held against both packages' trees built afresh
on the updated leaves. A tree of one proof of a B = 2 `commit_batch`
shares its layers' buffer with the other proof's tree: an update of one
leaves the other's leaves and layers as they were."""

import numpy as np
import pytest
import torch

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.hash import hashers as jhashers
from plonky2_tpu.hash import merkle as jmerkle
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.fri.oracle import commit_batch
from plonky2_tpu_torch.hash import hashers
from plonky2_tpu_torch.hash import merkle

DEV = torch.device("cpu")
HASHERS = ["poseidon", "poseidon2", "keccak25", "poseidon_bn128"]


def _hashers(name):
    port = {h.name: h for h in (hashers.POSEIDON, hashers.POSEIDON2,
                                hashers.KECCAK, hashers.POSEIDON_BN128)}
    return port[name], jhashers.HASHERS_BY_NAME[name]


def _layers(tree) -> list:
    return [np.asarray(gl.to_u64(x)) if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in tree.layers]


def _assert_same(port_tree, want_layers, lg_n) -> None:
    got = _layers(port_tree)
    assert len(got) == len(want_layers)
    for level, (a, b) in enumerate(zip(got, want_layers)):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {level}")
    for i in range(1 << lg_n):
        np.testing.assert_array_equal(
            port_tree.prove(i),
            np.stack([want_layers[lvl][(i >> lvl) ^ 1]
                      for lvl in range(len(want_layers) - 1)]))


@pytest.mark.parametrize("name", HASHERS)
@pytest.mark.parametrize("lg_n,leaf_size,cap_h", [(4, 7, 1), (6, 135, 2),
                                                  (5, 3, 0)])
def test_updates_match_jax(name, lg_n, leaf_size, cap_h):
    """One leaf, then a range across a subtree boundary, then a range that
    starts and ends on odd indices."""
    ph, jh = _hashers(name)
    rng = np.random.default_rng(9)
    n = 1 << lg_n
    leaves = rng.integers(0, ref.ORDER, size=(n, leaf_size), dtype=np.uint64)
    tree = merkle.MerkleTree(gl.from_u64(leaves, DEV), cap_h, ph)
    jtree = jmerkle.MerkleTree(GF.from_u64(leaves), cap_h, hasher=jh)
    for i in (0, 5, n - 1):
        np.testing.assert_array_equal(tree.prove(i), jtree.prove(i))
    for start, end in ((5, 6), (3, 9), (n // 2 - 3, n // 2 + 4)):
        new = rng.integers(0, ref.ORDER, size=(end - start, leaf_size),
                           dtype=np.uint64)
        leaves[start:end] = new
        if end - start == 1:
            tree.change_leaf_and_update(gl.from_u64(new[0], DEV), start)
        else:
            tree.change_leaves_in_range_and_update(gl.from_u64(new, DEV),
                                                   start, end)
        if name == "poseidon":
            if end - start == 1:
                jtree.change_leaf_and_update(GF.from_u64(new[0]), start)
            else:
                jtree.change_leaves_in_range_and_update(GF.from_u64(new),
                                                        start, end)
        else:
            jtree = jmerkle.MerkleTree(GF.from_u64(leaves), cap_h,
                                       hasher=jh)
        np.testing.assert_array_equal(tree.leaves_host(), leaves)
        _assert_same(tree, jtree._layers_host(), lg_n)
        fresh = merkle.MerkleTree(gl.from_u64(leaves, DEV), cap_h, ph)
        _assert_same(tree, _layers(fresh), lg_n)


@pytest.mark.parametrize("name", ["poseidon", "poseidon2"])
def test_update_leaves_other_proof_of_a_batch(name):
    """commit_batch of B = 2: proof 0's tree updated over a range that
    crosses a subtree boundary equals a fresh tree of its new leaves, and
    proof 1's leaves and layers are unchanged (the two trees' layers are
    views of one buffer)."""
    ph, _ = _hashers(name)
    rng = np.random.default_rng(3)
    num, lg_n, rate, cap = 10, 4, 2, 2
    coeffs = gl.from_u64(rng.integers(0, ref.ORDER, size=(num, 2, 1 << lg_n),
                                      dtype=np.uint64), DEV)
    batch = commit_batch(coeffs, rate, cap, ph)
    t0, t1 = (b.merkle_tree for b in batch.batches)
    # one buffer, two slices
    assert t0.layers[1].untyped_storage().data_ptr() == \
        t1.layers[1].untyped_storage().data_ptr()
    assert t0.layers[1].data_ptr() != t1.layers[1].data_ptr()
    before = ([x.clone() for x in t1.layers], t1.leaves.clone())
    N = 1 << (lg_n + rate)
    new = gl.from_u64(rng.integers(0, ref.ORDER, size=(12, num),
                                   dtype=np.uint64), DEV)
    t0.change_leaves_in_range_and_update(new, N // 2 - 5, N // 2 + 7)
    for a, b in zip(t1.layers, before[0]):
        assert torch.equal(a, b)
    assert torch.equal(t1.leaves, before[1])
    assert torch.equal(batch.leaves[1], before[1])
    fresh = merkle.MerkleTree(t0.leaves.clone(), cap, ph)
    for a, b in zip(t0.layers, fresh.layers):
        assert torch.equal(a, b)
    assert torch.equal(batch.leaves[0][N // 2 - 5:N // 2 + 7], new)
