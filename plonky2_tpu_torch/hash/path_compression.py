"""Merkle path compression: the siblings that several query paths share are
sent once (reference: plonky2/src/hash/path_compression.rs —
compress_merkle_proofs:11-52, decompress_merkle_proofs:54-112).

Host-side: paths are lists of sibling digests (rows, tuples or bytes, each
taken as the hasher's digest); compression is a proof-size step, not a
compute path.
"""

from __future__ import annotations


def compress_merkle_proofs(cap_height: int, indices, proofs, hasher) -> list:
    """Drop from each path the siblings that an earlier path in `indices`
    order, or the path itself, already determines."""
    assert proofs
    height = cap_height + len(proofs[0])
    num_leaves = 1 << height
    known = [False] * (2 * num_leaves)
    for i in indices:
        for j in range(height - cap_height):
            known[(i + num_leaves) >> j] = True
    compressed = []
    for i, path in zip(indices, proofs):
        out = []
        index = i + num_leaves
        for sibling in path:
            sibling_index = index ^ 1
            if not known[sibling_index]:
                out.append(hasher.digest_from_row(sibling))
                known[sibling_index] = True
            index >>= 1
            known[index] = True
        compressed.append(out)
    return compressed


def decompress_merkle_proofs(leaves_data, leaves_indices, compressed_proofs,
                             height: int, cap_height: int, hasher) -> list:
    """The full paths, from the leaves (in compression order) and the
    compressed paths, rehashing the nodes each path passes."""
    num_leaves = 1 << height
    seen: dict[int, object] = {}
    for i, v in zip(leaves_indices, leaves_data):
        seen[i + num_leaves] = hasher.hash_or_noop_oracle(
            [int(x) for x in v])
    iters = [iter(p) for p in compressed_proofs]
    for layer in range(height - cap_height):
        for i, it in zip(leaves_indices, iters):
            index = (i + num_leaves) >> layer
            current = seen[index]
            sibling_index = index ^ 1
            if sibling_index not in seen:
                seen[sibling_index] = hasher.digest_from_row(next(it))
            sibling = seen[sibling_index]
            seen[index >> 1] = (
                hasher.two_to_one_oracle(current, sibling) if index % 2 == 0
                else hasher.two_to_one_oracle(sibling, current))
    decompressed = []
    for i in leaves_indices:
        out = []
        index = i + num_leaves
        for _ in range(height - cap_height):
            out.append(seen[index ^ 1])
            index >>= 1
        decompressed.append(out)
    return decompressed
