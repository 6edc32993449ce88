"""Merkle tree with cap (reference: plonky2/src/hash/merkle_tree.rs).

The leaf layer is one batched hash_or_noop of the hasher (K3 or K7); the
layers above it come from the hasher's `merkle_layers` (the tree entry of
K2 or K6, at most two launches a tree) as views into one buffer; layer l,
node i covers leaves [i * 2^l, (i + 1) * 2^l), and the cap is the layer
with 2^cap_height nodes.
Leaves and digest layers stay on the tensor's device; proofs and rows are
gathered there and copied to the host once per call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..utils.bits import log2_strict


def build_layers(leaf_digests: torch.Tensor, cap_height: int,
                 hasher) -> list:
    """[N, 4] leaf digests -> digest layers, leaf layer first, cap last."""
    return [leaf_digests] + hasher.merkle_layers(leaf_digests, cap_height)


class MerkleTree:
    """leaves: int64 [N, leaf_size], hashed by `hasher`. `leaf_digests`
    lets a caller that already hashed the leaves (the commit, from the LDE
    columns) skip that pass; `layers` gives a whole prebuilt tree."""

    def __init__(self, leaves: torch.Tensor, cap_height: int, hasher,
                 leaf_digests: torch.Tensor | None = None,
                 layers: list | None = None):
        self.lg_n = log2_strict(leaves.shape[0])
        assert cap_height <= self.lg_n
        self.cap_height = cap_height
        self.leaves = leaves
        if layers is None:
            if leaf_digests is None:
                leaf_digests = hasher.hash_or_noop(leaves)
            layers = build_layers(leaf_digests, cap_height, hasher)
        self.layers = layers
        self._leaves_host = None

    @property
    def depth(self) -> int:
        return self.lg_n - self.cap_height

    def cap_digests(self) -> list:
        return [tuple(int(x) for x in row)
                for row in gl.to_u64(self.layers[-1])]

    def leaves_host(self) -> np.ndarray:
        if self._leaves_host is None:
            self._leaves_host = gl.to_u64(self.leaves)
        return self._leaves_host

    def rows_batch(self, indices) -> np.ndarray:
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.leaves.device)
        return gl.to_u64(self.leaves.index_select(0, idx))

    def prove_batch(self, indices) -> np.ndarray:
        """uint64 [k, depth, 4] sibling paths, leaf level first."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.leaves.device)
        if self.depth == 0:
            return np.zeros((len(idx), 0, 4), dtype=np.uint64)
        sibs = [self.layers[lvl].index_select(0, (idx >> lvl) ^ 1)
                for lvl in range(self.depth)]
        return gl.to_u64(torch.stack(sibs, dim=1))


def verify_merkle_proof_oracle(leaf: list[int], leaf_index: int, cap, proof,
                               hasher) -> bool:
    """verify_merkle_proof_to_cap (reference: merkle_proofs.rs:42-80) on the
    host; `cap` and `proof` rows are digests or uint64 digest rows."""
    digest = hasher.hash_or_noop_oracle(leaf)
    idx = leaf_index
    for sibling in proof:
        sib = hasher.digest_from_row(sibling)
        if idx & 1:
            digest = hasher.two_to_one_oracle(sib, digest)
        else:
            digest = hasher.two_to_one_oracle(digest, sib)
        idx >>= 1
    return digest == hasher.digest_from_row(cap[idx])
