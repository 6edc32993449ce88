"""Merkle tree with cap (reference: plonky2/src/hash/merkle_tree.rs).

Layer l, node i covers leaves [i * 2^l, (i + 1) * 2^l), and the cap is the
layer with 2^cap_height nodes. Where the layers are built depends on the
hasher (`hashers.py`):
- a device hasher (Poseidon, Poseidon2): the leaf layer is one batched
  hash_or_noop (K3 or K7); the layers above it come from the hasher's
  `merkle_layers` (the tree entry of K2 or K6, at most two launches a tree)
  as views into one buffer, all on the leaves' device;
- a host hasher (Keccak, PoseidonBN128): the leaves are copied to the host
  once and the layers are numpy arrays built with `hash_leaves_np` and
  `compress_np`, uint8 [n, 25] for Keccak and uint64 [n, 4] for BN128.
The leaves themselves stay on their device either way (the prover reads the
LDE back from them). Proofs and rows are gathered where the layers and the
leaves are, and copied to the host once per call.

The okx fork's mutable trees (reference merkle_tree.rs:638-805):
`change_leaves_in_range_and_update` writes new leaves and recomputes the
touched nodes, a window of nodes that halves at each level: on a device
tree the new leaves' digests through K3/K7 (`hash_or_noop`) and each
level's touched pairs through the permute entry of K2/K6 (`compress`),
written in place into the layers, which may be views into a buffer shared
with other trees (a batch's, `fri/oracle.py`): only this tree's rows
change; on a host tree the same window through `hash_leaves_np` and
`compress_np`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..utils import timing as tracing
from ..utils.bits import log2_strict


def build_layers(leaf_digests: torch.Tensor, cap_height: int,
                 hasher) -> list:
    """[N, 4] leaf digests -> digest layers, leaf layer first, cap last."""
    return [leaf_digests] + hasher.merkle_layers(leaf_digests, cap_height)


def build_host_layers(leaves: np.ndarray, cap_height: int, hasher) -> list:
    """uint64 [N, leaf_size] leaves -> numpy digest layers of a host hasher,
    leaf layer first, cap last."""
    layers = [hasher.hash_leaves_np(leaves)]
    for _ in range(log2_strict(leaves.shape[0]) - cap_height):
        layers.append(hasher.compress_np(layers[-1][0::2], layers[-1][1::2]))
    return layers


class MerkleTree:
    """leaves: int64 [N, leaf_size], hashed by `hasher`. `layers` gives a
    whole prebuilt tree (tensors for a device hasher, numpy arrays for a
    host hasher), as a commit builds from the LDE columns; without it the
    tree is built here, in the span `merkle trees` of the thread's active
    TimingTree, and counted in its counter `merkle_trees`."""

    def __init__(self, leaves: torch.Tensor, cap_height: int, hasher,
                 layers: list | None = None):
        self.lg_n = log2_strict(leaves.shape[0])
        assert cap_height <= self.lg_n
        self.cap_height = cap_height
        self.leaves = leaves
        self.hasher = hasher
        self._leaves_host = None
        if layers is None:
            with tracing.scope("merkle trees", leaves.device):
                if not hasher.device:
                    layers = build_host_layers(self.leaves_host(),
                                               cap_height, hasher)
                else:
                    layers = build_layers(hasher.hash_or_noop(leaves),
                                          cap_height, hasher)
                tracing.count("merkle_trees")
        self.layers = layers

    @property
    def depth(self) -> int:
        return self.lg_n - self.cap_height

    def cap_digests(self) -> list:
        cap = self.layers[-1]
        if self.hasher.device:
            cap = gl.to_u64(cap)
        return [self.hasher.digest_from_row(row) for row in cap]

    def leaves_host(self) -> np.ndarray:
        if self._leaves_host is None:
            self._leaves_host = gl.to_u64(self.leaves)
        return self._leaves_host

    def _indices(self, indices) -> torch.Tensor:
        """Leaf indices uploaded to the leaves' device (a host read: the
        upload waits on the card's queue)."""
        tracing.count("host_reads")
        return torch.as_tensor(np.asarray(indices, dtype=np.int64),
                               device=self.leaves.device)

    def rows_batch(self, indices) -> np.ndarray:
        return gl.to_u64(self.leaves.index_select(0, self._indices(indices)))

    def prove(self, leaf_index: int) -> np.ndarray:
        """[depth, digest_width] sibling path of one leaf, leaf level
        first."""
        return self.prove_batch([leaf_index])[0]

    def change_leaf_and_update(self, leaf: torch.Tensor,
                               leaf_index: int) -> None:
        """Replace one leaf [leaf_size] and recompute its path to the cap
        (reference: merkle_tree.rs change_leaf_and_update:638-695)."""
        self.change_leaves_in_range_and_update(leaf.reshape(1, -1),
                                               leaf_index, leaf_index + 1)

    def change_leaves_in_range_and_update(self, new_leaves: torch.Tensor,
                                          start: int, end: int) -> None:
        """Replace leaves [start, end) by new_leaves [end - start,
        leaf_size] and recompute the nodes above them (reference:
        merkle_tree.rs change_leaves_in_range_and_update:699-805)."""
        n, width = self.leaves.shape
        if not 0 <= start < end <= n:
            raise ValueError(f"leaf range [{start}, {end}) of {n} leaves")
        if tuple(new_leaves.shape) != (end - start, width):
            raise ValueError(f"new leaves {tuple(new_leaves.shape)} for "
                             f"[{end - start}, {width}]")
        new_leaves = new_leaves.to(self.leaves.device)
        self.leaves[start:end] = new_leaves
        self._leaves_host = None
        h = self.hasher
        layers = self.layers
        if h.device:
            layers[0][start:end] = h.hash_or_noop(new_leaves)
        else:
            layers[0][start:end] = h.hash_leaves_np(gl.to_u64(new_leaves))
        lo, hi = start, end
        for level in range(1, len(layers)):
            lo, hi = lo >> 1, (hi + 1) >> 1
            pairs = layers[level - 1][2 * lo:2 * hi]
            layers[level][lo:hi] = (h.compress(pairs[0::2], pairs[1::2])
                                    if h.device else
                                    h.compress_np(pairs[0::2], pairs[1::2]))

    def prove_batch(self, indices) -> np.ndarray:
        """[k, depth, digest_width] sibling paths, leaf level first: uint64
        rows, or uint8 rows for a byte digest."""
        h = self.hasher
        if self.depth == 0:
            return np.zeros((len(indices), 0, h.digest_width),
                            dtype=h.digest_dtype)
        if not h.device:
            idx = np.asarray(indices, dtype=np.int64)
            return np.stack([self.layers[lvl][(idx >> lvl) ^ 1]
                             for lvl in range(self.depth)], axis=1)
        idx = self._indices(indices)
        sibs = [self.layers[lvl].index_select(0, (idx >> lvl) ^ 1)
                for lvl in range(self.depth)]
        return gl.to_u64(torch.stack(sibs, dim=1))


def verify_merkle_proof_oracle(leaf: list[int], leaf_index: int, cap, proof,
                               hasher) -> bool:
    """verify_merkle_proof_to_cap (reference: merkle_proofs.rs:42-80) on the
    host; `cap` and `proof` rows are digests (tuples or bytes) or their
    numpy rows (uint64, or uint8 for a byte digest)."""
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
