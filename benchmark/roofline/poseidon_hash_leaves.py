"""K3, the Poseidon leaf hash (`csrc/poseidon.cu` poseidon_hash_leaves under
`hash/poseidon.py`): the work one call needs.

A call's shape is (L, n): n leaves of L elements, each hashed by the
rate-8 sponge, ceil(L / 8) permutations. Bytes: the leaves read once and
the 4-element digests written once, 8 (L n + 4 n). Field multiplies: a
permutation's x^7 S-boxes, 4 multiplies each, in 8 full rounds of 12 and 22
partial rounds of 1: 472; its MDS constants are below 2^6 (shifts and
adds). Bound: operations at every shape of the proofs measured here.
"""

KERNEL = "poseidon_hash_leaves"
TRACE_NAMES = (r"\bhash_leaves(_lanes)?_kernel"
               r"<(?:\(anonymous namespace\)::)?Poseidon>")
FIELD_MULS_PER_PERMUTATION = (8 * 12 + 22) * 4


def work(shape) -> tuple[float, float]:
    L, n = shape
    nbytes = 8 * (L * n + 4 * n)
    muls = FIELD_MULS_PER_PERMUTATION * n * -(-L // 8)
    return nbytes, muls
