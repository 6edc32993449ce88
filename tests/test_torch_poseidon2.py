"""The port's Poseidon2 (kernels K6/K7 through their plain versions on CPU)
against the JAX package: the permutation against JAX `poseidon2_permute` and
the host oracle, edge values included; the leaf sponge against JAX
`hash_no_pad_lanes`; compress against JAX `compress_lanes` and the host
two_to_one; Poseidon2 Merkle caps and paths against the JAX MerkleTree,
through the tree's plain path (which fills the tree kernel's buffer at its
offsets). Inputs are made by numpy from a seed. Tolerance: exact.

The CUDA kernels run only on the card, so their schedule is also held here:
the permutation of `csrc/poseidon2.cu` in its thread form and its 16-lane
form, on the python-int model of the Goldilocks arithmetic of
`csrc/goldilocks_lazy.cuh` (tests/test_torch_poseidon.py), with the
constant tables parsed from the generated `poseidon2_tables.h`, against the
JAX oracle on random, edge and non-canonical states.

The JAX lanes functions run their CPU path (the Pallas kernels run only on a
TPU or in interpret mode, which tests/test_pallas_poseidon2.py skips here)."""

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.hash import hashers as jhashers
from plonky2_tpu.hash import poseidon2 as jps2
from plonky2_tpu.hash import poseidon2_constants as jpc2
from plonky2_tpu.hash.merkle import MerkleTree as JMerkleTree
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon2 as ps2
from plonky2_tpu_torch.hash.hashers import POSEIDON2
from plonky2_tpu_torch.hash.merkle import (
    MerkleTree, verify_merkle_proof_oracle,
)
from plonky2_tpu_torch.hash.sponge import tree_offsets
from tests.test_torch_poseidon import (
    EDGE, M32, P, _add_canon, _kernel_tables, _mad_wide, _mul_add,
    _reduce_lh, _sbox,
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


@pytest.mark.parametrize("lg_n,cap_height", [(lg, cap) for lg in range(11)
                                             for cap in range(min(lg, 4) + 1)])
def test_tree_plain_path_vs_jax(lg_n, cap_height):
    """Caps and every proof of the Poseidon2 tree built through
    `merkle_layers` (the plain path of the tree kernel on CPU) against the
    JAX MerkleTree under Poseidon2, and its layers as views into one buffer
    at the kernel's offsets."""
    leaves = _rand(1 << lg_n, 7)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height, POSEIDON2)
    jtree = JMerkleTree(GF.from_u64(leaves), cap_height,
                        hasher=jhashers.POSEIDON2)
    assert tree.cap_digests() == \
        [tuple(int(x) for x in d) for d in jtree.cap_digests()]
    proofs = tree.prove_batch(list(range(1 << lg_n)))
    for i in range(1 << lg_n):
        np.testing.assert_array_equal(proofs[i], jtree.prove(i))
    offs = tree_offsets(1 << lg_n, cap_height)
    above = tree.layers[1:]
    assert len(above) == lg_n - cap_height == len(offs) - 1
    if above:
        base = above[0].data_ptr()
        storage = above[0].untyped_storage().data_ptr()
        for layer, lo, hi in zip(above, offs, offs[1:]):
            assert layer.shape == (hi - lo, 4)
            assert layer.untyped_storage().data_ptr() == storage
            assert layer.data_ptr() == base + 32 * lo


# ---------------------------------------------------------------------------
# The generated constant tables of csrc/poseidon2.cu
# ---------------------------------------------------------------------------

def _tables():
    return _kernel_tables("poseidon2_tables.h")


def _external_matrix():
    """The JAX oracle's external layer applied to the unit vectors."""
    cols = [jps2._external_layer([int(r == c) for r in range(12)])
            for c in range(12)]
    return [[cols[c][r] for c in range(12)] for r in range(12)]


def test_kernel_tables_match_the_jax_constants():
    t = _tables()
    rc, zeros = jpc2.RC12, [0] * 12
    rows = lambda k: t["C2_EXT_RC"][12 * k:12 * (k + 1)]
    assert len(t["C2_EXT_RC"]) == 9 * 12
    assert [rows(k) for k in range(9)] == \
        [rc[0], rc[1], rc[2], rc[3], zeros, rc[27], rc[28], rc[29], zeros]
    assert t["C2_PARTIAL_RC"] == [rc[4 + r][0] for r in range(22)]
    assert all(rc[4 + r][1:] == [0] * 11 for r in range(22))
    assert t["C2_MID_RC"] == rc[26]
    assert t["C2_DIAG"] == list(jpc2.MATRIX_DIAG_12)
    ext = _external_matrix()
    assert t["C2_EXT"] == [x for row in ext for x in row]
    assert max(t["C2_EXT"]) == 14 and \
        sorted({sum(row) for row in ext}) == [48, 64]


# ---------------------------------------------------------------------------
# The kernel's schedule on the python-int model of its arithmetic
# ---------------------------------------------------------------------------

def _m4(v):
    t0, t1 = v[0] + v[1], v[2] + v[3]
    t2, t3 = 2 * v[1] + t1, 2 * v[3] + t0
    t4, t5 = 4 * t1 + t3, 4 * t0 + t2
    return [t3 + t5, t5, t2 + t4, t4]


def _reduce_sums(L, H, widest):
    """reduce_lh of two half-sums, which must stay inside its range."""
    assert L < 1 << 64 and H < (1 << 64) - (1 << 32), (L, H)
    widest.append(max(L, H))
    return _reduce_lh(L, H)


def _external_model(s, rc, widest):
    """`external_layer`: M4 and the column sums on the halves in 64-bit
    integers, the next round's constants starting the sums."""
    lo, hi = [x & M32 for x in s], [x >> 32 for x in s]
    for b in (0, 4, 8):
        lo[b:b + 4], hi[b:b + 4] = _m4(lo[b:b + 4]), _m4(hi[b:b + 4])
    out = []
    for i in range(12):
        k = i % 4
        sl, sh = lo[k] + lo[4 + k] + lo[8 + k], hi[k] + hi[4 + k] + hi[8 + k]
        out.append(_reduce_sums(lo[i] + sl + (rc[i] & M32),
                                hi[i] + sh + (rc[i] >> 32), widest))
    return out


def _external_lanes_model(x, rc, t, widest):
    """`external_lanes`: lane l's row of E on the shuffled halves through
    mad.wide.u32, its constant starting the sums."""
    ext = t["C2_EXT"]
    out = []
    for lane in range(12):
        L, H = rc[lane] & M32, rc[lane] >> 32
        for c in range(12):
            L = _mad_wide(x[c] & M32, ext[12 * lane + c], L)
            H = _mad_wide(x[c] >> 32, ext[12 * lane + c], H)
        out.append(_reduce_sums(L, H, widest))
    return out


def _internal_model(s, t, widest):
    for r in range(22):
        s[0] = _sbox(_add_canon(s[0], t["C2_PARTIAL_RC"][r]))
        # the thread's two accumulators and the lanes' butterfly take the
        # same sums
        total = _reduce_sums(sum(x & M32 for x in s), sum(x >> 32 for x in s),
                             widest)
        s = [_mul_add(x, t["C2_DIAG"][i], total) for i, x in enumerate(s)]
    return [_add_canon(x, t["C2_MID_RC"][i]) for i, x in enumerate(s)]


def _permute2_model(state, t, form, widest):
    """The kernel's `permute` (form "thread") or `permute_lanes` (form
    "lanes") on the model arithmetic: values anywhere in [0, 2^64) between
    operations, canonical on the way out."""
    rc = lambda k: t["C2_EXT_RC"][12 * k:12 * (k + 1)]
    if form == "thread":
        ext = lambda s, k: _external_model(s, rc(k), widest)
    else:
        ext = lambda s, k: _external_lanes_model(s, rc(k), t, widest)
    s = ext(list(state), 0)
    for f in range(8):
        if f == 4:
            s = _internal_model(s, t, widest)
        s = ext([_sbox(x) for x in s], f + 1)
    return [x - P if x >= P else x for x in s]


@pytest.mark.parametrize("form", ["thread", "lanes"])
@pytest.mark.parametrize("kind", ["random", "edge", "non-canonical"])
def test_model_permutation_vs_oracle(form, kind):
    """Both forms of the kernel's Poseidon2 permutation and their tables,
    on the model arithmetic, against the JAX oracle; every input is taken
    as it is, non-canonical ones included (the oracle reduces them)."""
    t = _tables()
    rng = np.random.default_rng({"random": 1, "edge": 2,
                                 "non-canonical": 3}[kind])
    states = []
    for _ in range(3):
        if kind == "random":
            states.append([int(v) for v in rng.integers(0, P, 12,
                                                         dtype=np.uint64)])
        elif kind == "edge":
            states.append([EDGE[i] % P for i in rng.integers(0, len(EDGE),
                                                             12)])
        else:
            states.append([EDGE[i] for i in rng.integers(0, len(EDGE), 12)])
    if kind == "non-canonical":
        states.append([(1 << 64) - 1] * 12)
    for state in states:
        want = jps2.poseidon2_oracle([x % P for x in state])
        assert _permute2_model(state, t, form, []) == list(want)


@pytest.mark.parametrize("form", ["thread", "lanes"])
def test_model_external_layer_on_the_largest_inputs(form):
    """The halves' sums of the external layer on the largest state and
    constants stay below 2^64 (below 64 (2^32 - 1) + 2^32, in fact) and give
    E s + rc mod p."""
    t = _tables()
    s, rc, widest = [(1 << 64) - 1] * 12, [P - 1] * 12, []
    if form == "thread":
        got = _external_model(s, rc, widest)
    else:
        got = _external_lanes_model(s, rc, t, widest)
    assert max(widest) <= 64 * M32 + M32 < 1 << 39
    ext = _external_matrix()
    for r in range(12):
        want = (sum(ext[r][c] * s[c] for c in range(12)) + rc[r]) % P
        assert got[r] < 1 << 64 and got[r] % P == want
