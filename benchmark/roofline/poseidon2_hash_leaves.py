"""K7, the Poseidon2 leaf hash (`csrc/poseidon2.cu` poseidon2_hash_leaves
under `hash/poseidon2.py`): the work one call needs.

A call's shape is (L, n): n leaves of L elements, each hashed by the
rate-8 sponge, ceil(L / 8) permutations (one thread a column, or 16 lanes a
column up to 2^9 columns: the same permutations). Bytes: the leaves read
once and the 4-element digests written once, 8 (L n + 4 n). Field
multiplies: a permutation's x^7 S-boxes, 4 multiplies each, in 8 full
rounds of 12 and 22 internal rounds of 1, and the internal layer's 12
multiplies by its full 64-bit diagonal in each of the 22: 736; the external
layer's constants are below 2^4 (shifts and adds). Bound: operations at
every shape of the proofs measured here.
"""

KERNEL = "poseidon2_hash_leaves"
TRACE_NAMES = (r"\bhash_leaves(_lanes)?_kernel"
               r"<(?:\(anonymous namespace\)::)?Poseidon2>")
FIELD_MULS_PER_PERMUTATION = (8 * 12 + 22) * 4 + 22 * 12


def work(shape) -> tuple[float, float]:
    L, n = shape
    nbytes = 8 * (L * n + 4 * n)
    muls = FIELD_MULS_PER_PERMUTATION * n * -(-L // 8)
    return nbytes, muls
