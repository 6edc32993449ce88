"""The benchmark's reference for recursion_leaf_d14_poseidon2
(benchmark/reference/poseidon2.py, plain_torch_poseidon2.py,
generic_verifier.py, recursion_leaf_d14_poseidon2.py) against the JAX
package and the port, and the span and counter of the port's Merkle tree
builds.

- (a) The reference's Poseidon2 permutation, dense matrices written from
  the paper, equals the JAX package's and the port's `poseidon2_oracle` on
  seeded states, the zero state and the all-(p - 1) state; its constants
  are theirs.
- (b) Its plain-PyTorch lanes equal its python-int permutation, and its
  Merkle cap equals the port's `MerkleTree` cap under Poseidon2.
- (c) Its verifier key of the leaf at degree 6 under Poseidon2 equals the
  port's, and differs from the Poseidon leaf's.
- (d) A small Poseidon2 leaf proof (degree 6, 4 FRI queries) passes the
  reference's `check`; it is refused after one flipped opening and after
  one changed public input, and the same circuit's proof under Poseidon is
  refused.
- (e) A prove under an enabled TimingTree builds each of its trees in the
  span `merkle trees` and counts them in `merkle_trees`: the three PLONK
  oracles and one tree a FRI fold, under either hasher.

Tolerance: exact.
"""

import copy
import os
import random
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import load  # noqa: E402
from benchmark.reference import plain_torch  # noqa: E402
from benchmark.reference import plain_torch_poseidon2 as pt2  # noqa: E402
from benchmark.reference import poseidon2 as ps2  # noqa: E402
from benchmark.reference import \
    recursion_leaf_d14 as ref_leaf  # noqa: E402
from benchmark.reference import \
    recursion_leaf_d14_poseidon2 as ref_p2  # noqa: E402
from benchmark.reference.field import P  # noqa: E402
from benchmark.run import _apply  # noqa: E402
from plonky2_tpu.hash import poseidon2 as jax_ps2  # noqa: E402
from plonky2_tpu_torch.field import goldilocks as gl  # noqa: E402
from plonky2_tpu_torch.hash import poseidon2 as port_ps2  # noqa: E402
from plonky2_tpu_torch.hash.hashers import POSEIDON2  # noqa: E402
from plonky2_tpu_torch.hash.merkle import MerkleTree  # noqa: E402
from plonky2_tpu_torch.utils.timing import TimingTree  # noqa: E402

CONFIG = "recursion_leaf_d14_poseidon2"
CFG = load.data("configs", CONFIG)
PROGRAM = load.module("configs", CONFIG)
SEED = 2 ** 31 + 25
# the configuration cut to a proof the CPU makes in seconds
SMALL = {"degree_bits": 6, "fri": {"num_query_rounds": 4}}
POSEIDON_CONFIG = "PoseidonGoldilocksConfig"


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def _states() -> list:
    rnd = random.Random(SEED)
    return ([[rnd.randrange(P) for _ in range(12)] for _ in range(32)]
            + [[0] * 12, [P - 1] * 12])


# -- (a) the permutation -----------------------------------------------------

@pytest.mark.parametrize("state", _states(),
                         ids=[f"seeded{i}" for i in range(32)]
                         + ["zero", "p-1"])
def test_permutation_equals_both_packages(state):
    ours = ps2.permute(state)
    assert ours == jax_ps2.poseidon2_oracle(state) \
        == port_ps2.poseidon2_oracle(state)
    assert all(0 <= x < P for x in ours)


def test_constants_equal_both_packages():
    for consts in (jax_ps2, port_ps2):
        assert [list(row) for row in ps2.RC12] == consts.RC12
        assert list(ps2.MATRIX_DIAG_12) == consts.MATRIX_DIAG_12
        assert (ps2.HALF_FULL_ROUNDS * 2, ps2.PARTIAL_ROUNDS) == (
            consts.ROUNDS_F, consts.ROUNDS_P)
    assert [list(row) for row in ps2.EXTERNAL] == \
        port_ps2.external_matrix()


# -- (b) the plain-PyTorch permutation and Merkle cap ------------------------

def test_plain_lanes_equal_the_permutation():
    states = _states()
    lanes = plain_torch.from_u64(np.asarray(states, dtype=np.uint64).T,
                                 "cpu")
    got = pt2.permute_lanes(lanes, pt2._tables("cpu"))
    assert plain_torch.to_u64(got).T.tolist() == [ps2.permute(s)
                                                  for s in states]


@pytest.mark.parametrize("cap_height", [0, 2])
def test_merkle_cap_equals_the_port_s(cap_height):
    rng = np.random.default_rng(SEED + cap_height)
    leaves = rng.integers(0, P, (1 << 6, 135), dtype=np.uint64)
    ours = pt2.merkle_cap(plain_torch.from_u64(leaves.T, "cpu"), cap_height)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height, POSEIDON2)
    assert ours == [tuple(int(x) for x in d) for d in tree.cap_digests()]
    assert len(ours) == 1 << cap_height


# -- (c) the verifier key ----------------------------------------------------

_CACHE = {}


def small_cfg(hasher: str = CFG["hasher"]) -> dict:
    return _apply(CFG, dict(SMALL, hasher=hasher))


def system(hasher: str = CFG["hasher"]):
    """The configuration's own System at the small size, built once."""
    if hasher not in _CACHE:
        _CACHE[hasher] = PROGRAM.System(small_cfg(hasher), "cpu", SEED)
    return _CACHE[hasher]


def ref_circuit():
    """The reference's circuit at the small size, worked out once."""
    if "circuit" not in _CACHE:
        _CACHE["circuit"] = ref_p2.circuit(small_cfg(), "cpu")
    return _CACHE["circuit"]


def test_key_equals_the_port_s():
    ours = ref_circuit()
    theirs = system().data.verifier_only
    assert ours.cap == [tuple(int(x) for x in d)
                        for d in theirs.constants_sigmas_cap]
    assert ours.digest == tuple(int(x) for x in theirs.circuit_digest)
    poseidon = ref_leaf.circuit(small_cfg(POSEIDON_CONFIG), "cpu")
    assert ours.cap != poseidon.cap and ours.digest != poseidon.digest
    assert [g.id for g in ours.gates] == [g.id for g in poseidon.gates]


def test_reference_refuses_another_hasher():
    with pytest.raises(ValueError):
        ref_p2.circuit(small_cfg(POSEIDON_CONFIG), "cpu")


# -- (d) small proofs through the check ---------------------------------------

INPUTS = [5, P - 1, 0, 2 ** 40]


def proved(hasher: str = CFG["hasher"]) -> tuple:
    """(plain proof, its enabled TimingTree) of the request INPUTS, proved
    once under `hasher`."""
    if ("proof", hasher) not in _CACHE:
        s = system(hasher)
        tree = TimingTree(enabled=True)
        proof = s.prove(s.prepare([INPUTS]), tree)[0]
        _CACHE["proof", hasher] = PROGRAM.System.plain(proof), tree
    return _CACHE["proof", hasher]


def _proof(hasher: str = CFG["hasher"]) -> dict:
    return copy.deepcopy(proved(hasher)[0])


def check(proof: dict):
    calls = [{"inputs": [INPUTS], "proofs": [proof]}]
    return ref_p2.check(small_cfg(), calls, [0], "cpu")


@pytest.fixture
def known_key(monkeypatch):
    """The check's circuit taken from `ref_circuit` (the key worked out
    once, which `test_key_equals_the_port_s` holds to the port's)."""
    monkeypatch.setattr(ref_p2, "circuit", lambda cfg, device: ref_circuit())


def test_small_proof_passes_the_reference(known_key):
    numbers, reasons = check(_proof())
    assert numbers == {"wrong_inputs": (0, 0), "refused": (0, 0)}, reasons


def _flip_opening(plain):
    w = plain["openings"]["wires"]
    w[7] = ((w[7][0] + 1) % P, w[7][1])


def _change_input(plain):
    plain["public_inputs"][2] = (plain["public_inputs"][2] + 1) % P


@pytest.mark.parametrize("tamper,number", [(_flip_opening, "refused"),
                                           (_change_input, "wrong_inputs")],
                         ids=["opening", "public-input"])
def test_small_proof_tampered_is_refused(tamper, number, known_key):
    proof = _proof()
    tamper(proof)
    numbers, reasons = check(proof)
    assert numbers["refused"] == (1, 0), reasons
    assert numbers[number][0] == 1


def test_poseidon_proof_is_refused(known_key):
    """The same circuit and request proved under PoseidonGoldilocksConfig:
    the check holds the proof to Poseidon2's trees and transcript."""
    numbers, reasons = check(_proof(POSEIDON_CONFIG))
    assert numbers == {"wrong_inputs": (0, 0), "refused": (1, 0)}, reasons


# -- (e) the Merkle trees' span and counter -----------------------------------

@pytest.mark.parametrize("hasher", [CFG["hasher"], POSEIDON_CONFIG])
def test_merkle_trees_span_and_count(hasher):
    tree = proved(hasher)[1]
    common = system(hasher).data.common
    trees = 3 + len(common.fri_params.reduction_arity_bits)
    assert trees == 4
    assert tree.counts["merkle_trees"] == trees
    assert tree.span_counts["merkle trees"]["merkle_trees"] == trees
    spans = {s.id: s for s in tree.spans}
    parents = sorted(spans[s.parent].label for s in tree.spans
                     if s.label == "merkle trees")
    assert parents == sorted(["wires commitment",
                              "zs+partial_products commitment",
                              "quotient commitment"]
                             + ["fold codewords in the commitment phase"]
                             * (trees - 3))
    assert tree.seconds()["merkle trees"] > 0
