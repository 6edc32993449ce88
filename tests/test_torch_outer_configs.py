"""The port's KeccakGoldilocksConfig and PoseidonBN128GoldilocksConfig, the
configs of a recursion chain's outer proof, against the JAX package on the
CPU, all exact: keccak256 (scalar and batched) and the Keccak challenger
permutation with its rejection sampling; the BN128 permutation in Python and
in the threaded C library, against the reference's known answers; host
Merkle trees of both hashers; a Keccak proof's bytes read back; fib(21)
under each config, built by the port and built by JAX and carried over by
`convert.py`, equal to its golden transcript, verified by both packages;
tampered proofs rejected."""

import copy
import os
import random

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.hash import hashers as jhashers
from plonky2_tpu.hash import keccak as jkeccak
from plonky2_tpu.hash import poseidon_bn128 as jbn
from plonky2_tpu.hash.merkle import MerkleTree as JMerkleTree
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch import host
from plonky2_tpu_torch.convert import circuit_data_from_arrays, common_from
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field import reference as ref
from plonky2_tpu_torch.hash import keccak as kk
from plonky2_tpu_torch.hash import poseidon_bn128 as bn
from plonky2_tpu_torch.hash.hashers import (
    CONFIGS, KECCAK, POSEIDON_BN128, digest_to_elements,
)
from plonky2_tpu_torch.hash.merkle import MerkleTree, verify_merkle_proof_oracle
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.utils.serialization import (
    deserialize_proof_with_pis, serialize_proof_with_pis,
)
from tests.test_torch_prover import (
    GOLDEN_DIR, _assert_golden, _fib, _jax_verify,
)

KECCAK_GC = "KeccakGoldilocksConfig"
BN128_GC = "PoseidonBN128GoldilocksConfig"
OUTER = [KECCAK_GC, BN128_GC]
HOST_HASHERS = {"keccak": (KECCAK, jhashers.KECCAK),
                "bn128": (POSEIDON_BN128, jhashers.POSEIDON_BN128)}


def _golden(name):
    return os.path.join(GOLDEN_DIR, f"fib21_{name}_transcript.json")


def _rand_u64(rng, *shape):
    return rng.integers(0, ref.ORDER, size=shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# Keccak
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 272])
def test_keccak256_against_jax_and_batched(length):
    """The scalar keccak256 against JAX's (the rate is 136 bytes: one, two
    and three blocks) and the batched numpy form against the scalar one."""
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, size=(5, length), dtype=np.uint8)
    batch = kk.keccak256_np(rows)
    assert batch.shape == (5, 32) and batch.dtype == np.uint8
    for row, got in zip(rows, batch):
        want = jkeccak.keccak256(row.tobytes())
        assert kk.keccak256(row.tobytes()) == want
        assert got.tobytes() == want


def test_keccak256_known_answers():
    """tests/test_keccak.py's answers (ethereum keccak256, 0x01 padding)."""
    assert kk.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert kk.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")


def test_keccak_hasher_oracles_against_jax():
    rng = random.Random(25)
    for n in (0, 1, 3, 4, 8, 17):
        xs = [rng.randrange(ref.ORDER) for _ in range(n)]
        assert KECCAK.hash_or_noop_oracle(xs) == \
            jhashers.KECCAK.hash_or_noop_oracle(xs)
        assert KECCAK.hash_pad_oracle(xs) == \
            jhashers.KECCAK.hash_pad_oracle(xs)
    d = KECCAK.hash_no_pad_oracle([1, 2, 3, 4, 5])
    assert len(d) == 25
    assert KECCAK.two_to_one_oracle(d, d[::-1]) == \
        jhashers.KECCAK.two_to_one_oracle(d, d[::-1])
    assert digest_to_elements(d) == jhashers.digest_to_elements(d)
    assert len(digest_to_elements(d)) == 4


def test_keccak_permutation_against_jax():
    """The challenger's hash onion, scalar and batched, against JAX's."""
    rng = np.random.default_rng(12)
    states = _rand_u64(rng, 16, 12)
    batch = KECCAK.permute_many_host(states)
    for s, got in zip(states, batch):
        want = jhashers.KECCAK.permute_oracle([int(x) for x in s])
        assert KECCAK.permute_oracle([int(x) for x in s]) == want
        assert [int(x) for x in got] == want


def test_keccak_permutation_rejection(monkeypatch):
    """A crafted keccak256 whose output word 0 is 2^64 - 1 (above the order)
    whenever the true output's first byte is below 0x80, in both packages
    and in the batched form: rejected words are skipped, rows of the batch
    with one take the scalar onion (some needing a fourth layer), and every
    result equals JAX's under the same crafted hash."""
    real, real_np = kk.keccak256, kk.keccak256_np
    crafted = {"scalar": 0}

    def scalar(data):
        h = real(data)
        if h[0] < 0x80:
            crafted["scalar"] += 1
            return b"\xff" * 8 + h[8:]
        return h

    def batched(data):
        h = real_np(data)
        h[h[:, 0] < 0x80, :8] = 0xFF
        return h

    monkeypatch.setattr(kk, "keccak256", scalar)
    monkeypatch.setattr(kk, "keccak256_np", batched)
    monkeypatch.setattr(jkeccak, "keccak256", scalar)
    rng = np.random.default_rng(13)
    states = _rand_u64(rng, 24, 12)
    batch = KECCAK.permute_many_host(states)
    for s, got in zip(states, batch):
        want = jhashers.KECCAK.permute_oracle([int(x) for x in s])
        assert KECCAK.permute_oracle([int(x) for x in s]) == want
        assert [int(x) for x in got] == want
        assert all(w < ref.ORDER for w in want)
    assert crafted["scalar"] > 24


# ---------------------------------------------------------------------------
# PoseidonBN128
# ---------------------------------------------------------------------------

def test_bn128_permutation_python_and_c_against_jax():
    assert host.load_bn128() is not None, "the BN128 C library must build"
    rng = random.Random(0xB128)
    for _ in range(3):
        st = [rng.randrange(1 << 64) for _ in range(12)]
        want = jbn.permute_bn128(st)
        assert bn.permute_bn128(st) == want
        assert host.bn128_permute(st) == want
    for n in (1, 8, 9, 17):
        xs = [rng.randrange(1 << 64) for _ in range(n)]
        assert host.bn128_hash_no_pad(xs) == \
            tuple(jbn.hash_no_pad_bn128(xs))
        assert POSEIDON_BN128.hash_no_pad_oracle(xs) == \
            jhashers.POSEIDON_BN128.hash_no_pad_oracle(xs)


def test_bn128_reference_known_answers():
    """reference: poseidon_bn128.rs:218-289, as tests/test_poseidon_bn128.py
    holds them: hash_no_pad, two_to_one and the public-input hash (which
    delegates to Goldilocks Poseidon)."""
    v = [8917524657281059100, 13029010200779371910, 16138660518493481604,
         17277322750214136960, 1441151880423231822]
    want = (16736853722845225729, 1446699130810517790, 15445626857806971868,
            6331160477881736675)
    assert tuple(bn.hash_no_pad_bn128(v)) == want
    assert POSEIDON_BN128.hash_no_pad_oracle(v) == want
    left = bytes([1, 2, 3, 4, 5, 6, 7, 8] * 4)
    right = bytes([8, 9, 3, 4, 5, 6, 7, 8] + [1, 2, 3, 4, 5, 6, 7, 8] * 2
                  + [1, 2, 3, 4, 5, 6, 7, 1])
    lt = [int.from_bytes(left[8 * i:8 * i + 8], "little") for i in range(4)]
    rt = [int.from_bytes(right[8 * i:8 * i + 8], "little") for i in range(4)]
    want = (5894400909438531414, 4814851992117646301, 17814584260098324190,
            15859500576163309036)
    assert POSEIDON_BN128.two_to_one_oracle(lt, rt) == want
    compressed = host.bn128_compress_many(np.asarray([lt], dtype=np.uint64),
                                          np.asarray([rt], dtype=np.uint64))
    assert tuple(int(x) for x in compressed[0]) == want
    v = [8917524657281059100, 13029010200779351910, 16138660518493481604,
         17277322750214136960, 1441151880423231811]
    assert CONFIGS[BN128_GC].hash_public_inputs(v) == [
        2325439551141788444, 15244397589056680708,
        5900587506047513594, 7217031981798124005]


def test_bn128_batches_do_not_depend_on_threads():
    """permute_many, hash_leaves (sponged and packed rows) and
    compress_many give the same bytes with 1 and 3 threads, and rows that
    the JAX library computes the same."""
    from plonky2_tpu import native

    rng = np.random.default_rng(3)
    states = rng.integers(0, 1 << 64, size=(10, 12), dtype=np.uint64)
    one = host.bn128_permute_many(states, 1)
    np.testing.assert_array_equal(one, host.bn128_permute_many(states, 3))
    assert [int(x) for x in one[4]] == \
        jbn.permute_bn128([int(x) for x in states[4]])
    for width in (135, 3):
        leaves = _rand_u64(rng, 10, width)
        one = host.bn128_hash_leaves(leaves, 1)
        np.testing.assert_array_equal(one, host.bn128_hash_leaves(leaves, 3))
        np.testing.assert_array_equal(one, native.bn128_hash_leaves(leaves))
    left, right = _rand_u64(rng, 7, 4), _rand_u64(rng, 7, 4)
    one = host.bn128_compress_many(left, right, 1)
    np.testing.assert_array_equal(one,
                                  host.bn128_compress_many(left, right, 3))
    np.testing.assert_array_equal(one, native.bn128_compress_many(left,
                                                                  right))


# ---------------------------------------------------------------------------
# Host Merkle trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hasher_name", sorted(HOST_HASHERS))
@pytest.mark.parametrize("width", [135, 3])
def test_host_merkle_tree_against_jax(hasher_name, width):
    """Layers, cap and every path of a tree of 64 leaves (sponged, and
    packed into the digest) to cap height 2 against the JAX MerkleTree; the
    port's paths verify and a changed leaf does not."""
    hasher, jhasher = HOST_HASHERS[hasher_name]
    leaves = _rand_u64(np.random.default_rng(width), 64, width)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), 2, hasher)
    jtree = JMerkleTree(GF.from_u64(leaves), 2, hasher=jhasher)
    assert len(tree.layers) == len(jtree._layers_np) == 5
    for ours, theirs in zip(tree.layers, jtree._layers_np):
        assert ours.dtype == theirs.dtype == hasher.digest_dtype
        np.testing.assert_array_equal(ours, theirs)
    assert tree.cap_digests() == jtree.cap_digests()
    proofs = tree.prove_batch(list(range(64)))
    assert proofs.shape == (64, 4, hasher.digest_width)
    for i in range(64):
        np.testing.assert_array_equal(proofs[i], jtree.prove(i))
    np.testing.assert_array_equal(tree.rows_batch([5, 9]), leaves[[5, 9]])
    leaf = [int(v) for v in leaves[5]]
    assert verify_merkle_proof_oracle(leaf, 5, tree.cap_digests(), proofs[5],
                                      hasher)
    leaf[0] = (leaf[0] + 1) % ref.ORDER
    assert not verify_merkle_proof_oracle(leaf, 5, tree.cap_digests(),
                                          proofs[5], hasher)


# ---------------------------------------------------------------------------
# fib(21) under each outer config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=OUTER)
def outer_fib21(request):
    """(config name, the port's fib(21) data and proof, the JAX builder's
    fib(21) circuit and its witness)."""
    name = request.param
    data, pw = _fib(CircuitBuilder, CircuitConfig, steps=20, device="cpu",
                    gc=CONFIGS[name])
    jdata, jpw = _fib(JBuilder, JCircuitConfig, steps=20,
                      gc=jhashers.CONFIGS[name])
    return name, (data, data.prove(pw)), (jdata, jpw)


def test_port_fib21_matches_golden(outer_fib21):
    """Bytes and every transcript field; the circuit as JAX builds it; the
    JAX verifier reads the port's bytes and accepts them."""
    name, (data, proof), (jdata, _) = outer_fib21
    _assert_golden(data, proof, _golden(name))
    assert common_from(jdata.common) == data.common
    assert data.verifier_only.circuit_digest == \
        jdata.verifier_only.circuit_digest
    assert data.verifier_only.constants_sigmas_cap == \
        jdata.verifier_only.constants_sigmas_cap
    if name == KECCAK_GC:
        assert isinstance(data.verifier_only.circuit_digest, bytes)
        assert len(data.verifier_only.circuit_digest) == 25
    data.verify(proof)
    _jax_verify(proof, data, jdata)


def test_jax_built_fib21_proved_by_port_matches_golden(outer_fib21):
    name, _, (jdata, pw) = outer_fib21
    po = jdata.prover_only
    tree = po.constants_sigmas_commitment.merkle_tree
    data = circuit_data_from_arrays(
        jdata.common,
        polynomials=po.constants_sigmas_commitment.polynomials.to_u64(),
        leaves=tree.leaves_host(), layers=tree._layers_host(),
        sigmas=po.sigmas, subgroup=po.subgroup,
        representative_map=po.representative_map,
        circuit_digest=po.circuit_digest, generators=po.generators,
        public_inputs=po.public_inputs, device="cpu")
    assert data.common.gc is CONFIGS[name]
    proof = data.prove(pw)
    _assert_golden(data, proof, _golden(name))
    data.verify(proof)


def test_proof_bytes_round_trip(outer_fib21):
    """The proof read back from its bytes is written to the same bytes and
    verifies; its caps and paths are 25-byte digests."""
    name, (data, proof), (jdata, _) = outer_fib21
    raw = serialize_proof_with_pis(proof, data.common)
    back = deserialize_proof_with_pis(raw, data.common)
    assert serialize_proof_with_pis(back, data.common) == raw
    data.verify(back)
    jback = jser.deserialize_proof_with_pis(raw, jdata.common)
    assert jser.serialize_proof_with_pis(jback, jdata.common) == raw
    digest = back.proof.wires_cap[0]
    path = back.proof.opening_proof.query_round_proofs[0] \
        .initial_trees_proof.evals_proofs[1][1]
    if name == KECCAK_GC:
        assert isinstance(digest, bytes) and len(digest) == 25
        assert path.dtype == np.uint8 and path.shape[1] == 25
    else:
        assert len(digest) == 4 and path.shape[1] == 4


def _tamper(proof, what):
    bad = copy.deepcopy(proof)
    p = bad.proof
    if what == "cap":
        d = p.wires_cap[0]
        p.wires_cap[0] = (bytes([d[0] ^ 1]) + d[1:]
                          if isinstance(d, bytes)
                          else ((d[0] + 1) % ref.ORDER,) + tuple(d[1:]))
    elif what == "opening":
        w = p.openings.wires
        w[0] = ((w[0][0] + 1) % ref.ORDER, w[0][1])
    else:
        bad.public_inputs[2] = (bad.public_inputs[2] + 1) % ref.ORDER
    return bad


@pytest.mark.parametrize("what", ["cap", "opening", "public_input"])
def test_port_verifier_rejects_tampering(outer_fib21, what):
    """A flipped byte (Keccak) or element (BN128) of the wires cap, a
    flipped opening and a flipped public input."""
    _, (data, proof), _ = outer_fib21
    with pytest.raises(AssertionError):
        data.verify(_tamper(proof, what))
