"""The port's Poseidon (kernels K2/K3 through their plain versions on CPU)
and Merkle tree against the JAX package: the permutation against the host
oracle and the reference KATs, the leaf sponge against the JAX device
sponge, caps and proofs against the JAX MerkleTree. Tolerance: exact.

The JAX sponge runs as the JAX package's own CPU tests run it
(tests/test_poseidon.py): `hash_no_pad` on [B, L] rows, the same sponge as
`hash_no_pad_lanes` in the other layout. The lanes form itself is not run:
on XLA:CPU it takes tens of minutes, which is why tests/test_pallas_poseidon
skips on CPU."""

import os

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.hash import poseidon as jps
from plonky2_tpu.hash.merkle import MerkleTree as JMerkleTree
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon as ps
from plonky2_tpu_torch.hash.hashers import POSEIDON
from plonky2_tpu_torch.hash.merkle import (
    MerkleTree, verify_merkle_proof_oracle,
)
from tests.test_poseidon import KATS

RNG = np.random.default_rng(9)


def _rand(*shape):
    return RNG.integers(0, ref.ORDER, size=shape, dtype=np.uint64)


def test_permute_kats():
    states = gl.from_u64(np.asarray([k[0] for k in KATS], dtype=np.uint64),
                         "cpu")
    want = np.asarray([k[1] for k in KATS], dtype=np.uint64)
    np.testing.assert_array_equal(gl.to_u64(ps.permute(states)), want)
    for inp, out in KATS:
        assert ps.permute_host(inp) == out


def test_permute_vs_oracle_random():
    x = _rand(64, 12)
    got = gl.to_u64(ps.permute(gl.from_u64(x, "cpu")))
    want = [jps.poseidon_oracle([int(v) for v in row]) for row in x]
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.uint64))


@pytest.mark.parametrize("L", [5, 8, 20, 32, 135])
def test_leaf_sponge_vs_jax(L):
    x = _rand(L, 256)
    got = gl.to_u64(ps.hash_leaves(gl.from_u64(x, "cpu")))       # [256, 4]
    want = jps.hash_no_pad(GF.from_u64(x.T.copy())).to_u64()     # [256, 4]
    np.testing.assert_array_equal(got, want)
    assert list(got[3]) == jps.hash_no_pad_oracle([int(v) for v in x[:, 3]])


def test_host_oracles():
    x = [int(v) for v in _rand(21)]
    assert list(POSEIDON.hash_no_pad_oracle(x)) == jps.hash_no_pad_oracle(x)
    assert list(POSEIDON.hash_or_noop_oracle(x[:3])) == \
        jps.hash_or_noop_oracle(x[:3])
    assert list(POSEIDON.two_to_one_oracle(x[:4], x[4:8])) == \
        jps.compress_oracle(x[:4], x[4:8])
    left, right = _rand(7, 4), _rand(7, 4)
    got = gl.to_u64(ps.compress(gl.from_u64(left, "cpu"),
                                gl.from_u64(right, "cpu")))
    want = [jps.compress_oracle([int(v) for v in a], [int(v) for v in b])
            for a, b in zip(left, right)]
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.uint64))


@pytest.mark.parametrize("lg_n", range(3, 9))
def test_merkle_vs_jax(lg_n):
    cap_height = min(4, lg_n)
    leaves = _rand(1 << lg_n, 135)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height, POSEIDON)
    jtree = JMerkleTree(GF.from_u64(leaves), cap_height)
    assert tree.cap_digests() == jtree.cap_digests()
    idx = list(range(1 << lg_n))
    proofs = tree.prove_batch(idx)
    for i in idx:
        np.testing.assert_array_equal(proofs[i], jtree.prove(i))
    for i in (0, (1 << lg_n) - 1):
        leaf = [int(v) for v in leaves[i]]
        assert verify_merkle_proof_oracle(leaf, i, tree.cap_digests(),
                                          proofs[i], POSEIDON)
        leaf[0] = (leaf[0] + 1) % ref.ORDER
        assert not verify_merkle_proof_oracle(leaf, i, tree.cap_digests(),
                                              proofs[i], POSEIDON)


@pytest.mark.parametrize("swap", [0, 1])
def test_poseidon_gate_trace_python_matches_native(swap):
    """The PoseidonGate witness row without a C compiler equals the host C
    trace the generator uses when one is present."""
    from plonky2_tpu_torch import host
    from plonky2_tpu_torch.gates.poseidon_gate import (
        _TRACE_COLS, _trace_python,
    )
    inputs = [int(v) for v in _rand(12)]
    trace = host.poseidon_generator_trace(inputs, swap)
    if trace is None:
        pytest.skip("no C compiler for the native trace")
    got = _trace_python(inputs, swap)
    assert [got[c] for c in _TRACE_COLS] == [trace[c] for c in _TRACE_COLS]


def test_build_key_follows_sources_tables_and_flags(tmp_path):
    """A kernel or host library is named by a hash of its sources, its
    generated constant headers and its compiler command, so a build left
    from other sources or other constants is never loaded."""
    from plonky2_tpu_torch import backend, host
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    tables = backend._tables()
    key = backend.build_key([str(src)], tables, ["-O3"])
    assert key == backend.build_key([str(src)], backend._tables(), ["-O3"])
    src.write_text("// v2\n")
    assert backend.build_key([str(src)], tables, ["-O3"]) != key
    src.write_text("// v1\n")
    edited = dict(tables)
    edited["poseidon2_tables.h"] += "// one more line\n"
    assert backend.build_key([str(src)], edited, ["-O3"]) != key
    assert backend.build_key([str(src)], tables, ["-O2"]) != key
    lib = host.load()
    if lib is not None:
        name = os.path.basename(lib._name)
        assert name.startswith("libplonky2_host-") and len(name) == 35
