"""K6's tree entry, the Poseidon2 Merkle tree (`csrc/poseidon2.cu`
poseidon2_merkle_tree under `hash/poseidon2.py`): the work one call needs.

A call's shape is (n, cap_height): the layers above n leaf digests down to
the 2^cap_height digests of the cap, n - 2^cap_height compressions, one
permutation each, in one or two launches. Bytes: the leaf digests read
once, 32 n, and every node above them written once, 32 (n - 2^cap_height).
Field multiplies: 736 a permutation (`poseidon2_hash_leaves.py`). Bound:
operations at every shape of the proofs measured here.
"""

from benchmark.roofline.poseidon2_hash_leaves import \
    FIELD_MULS_PER_PERMUTATION

KERNEL = "poseidon2_merkle_tree"
TRACE_NAMES = r"\bmerkle_kernel<(?:\(anonymous namespace\)::)?Poseidon2>"


def work(shape) -> tuple[float, float]:
    n, cap_height = shape
    nodes = n - (1 << cap_height)
    return 32 * (n + nodes), FIELD_MULS_PER_PERMUTATION * nodes
