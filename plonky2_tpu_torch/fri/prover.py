"""FRI prover: commit/fold layers, proof-of-work grind, query rounds
(reference fri/prover.rs — fri_committed_trees
:70-114, fri_proof_of_work:117-161, query rounds :164-218).

`fri_proof` scopes its three phases on the thread's active TimingTree
(`utils/timing.scope`), under plonky2's timed! labels where plonky2 has
them: `fold codewords in the commitment phase` (each fold's cap observation
and beta draw a `challenges` scope inside it), `find proof-of-work
witness`, and `FRI query rounds`."""

from __future__ import annotations

import numpy as np
import torch

from ..field import reference as ref
from ..field.extension import GF2
from ..hash.merkle import MerkleTree
from ..hash.sponge import SPONGE_RATE, W
from ..iop.challenger import Challenger
from ..ops import ntt
from ..ops.polynomial import horner_fold
from ..utils import timing as tracing
from .config import FriParams
from .proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep


def _brv_leaves(values: GF2, arity: int) -> torch.Tensor:
    """[n] ext values -> bit-reversed, arity-chunked leaves [n/arity,
    2*arity], each element flattened as (c0, c1)."""
    c0 = ntt.leaf_order(values.c0, 0).reshape(-1, arity)
    c1 = ntt.leaf_order(values.c1, 0).reshape(-1, arity)
    return torch.stack([c0, c1], dim=-1).reshape(c0.shape[0], 2 * arity)


def fri_committed_trees(coeffs: GF2, values: GF2, challenger: Challenger,
                        fri_params: FriParams):
    trees = []
    shift = ref.MULTIPLICATIVE_GROUP_GENERATOR
    cap_height = fri_params.config.cap_height
    for arity_bits in fri_params.reduction_arity_bits:
        tree = MerkleTree(_brv_leaves(values, 1 << arity_bits), cap_height,
                          challenger.hasher)
        trees.append(tree)
        with tracing.scope("challenges"):
            challenger.observe_cap(tree.cap_digests())
            beta = challenger.get_extension_challenge()
        shift = ref.exp(shift, 1 << arity_bits)
        coeffs = horner_fold(coeffs, beta, arity_bits)
        values = ntt.coset_fft_ext(coeffs, shift)
    final_len = coeffs.shape[-1] >> fri_params.config.rate_bits
    final_coeffs = coeffs[:final_len].to_pairs()
    challenger.observe_extension_elements(final_coeffs)
    return trees, final_coeffs


def _pow_wave(permute, state, witness_pos: int, pow_bits: int, batch: int,
              device) -> int:
    """Grind in waves of `batch` candidates through the device permutation
    `permute` (a kernel on a CUDA tensor); the smallest witness of the
    first wave that has one whose response's top `pow_bits` bits are 0
    (with 0 bits, witness 0)."""
    if pow_bits == 0:
        return 0
    tracing.count("host_reads")                  # the state's upload
    base = torch.as_tensor(np.asarray(state, dtype=np.uint64).view(np.int64),
                           device=device)
    start = 0
    while True:
        states = base.expand(batch, W).clone()
        states[:, witness_pos] = torch.arange(start, start + batch,
                                              device=device)
        r = permute(states)[:, SPONGE_RATE - 1]
        # int64 holds the u64 pattern: >> sign-extends, so the top bits
        # are all 0 exactly when the shifted value is 0
        tracing.count("host_reads")              # nonzero's size
        hits = torch.nonzero((r >> (64 - pow_bits)) == 0)
        if hits.numel():
            tracing.count("host_reads")
            return start + int(hits[0, 0])
        start += batch
        assert start < 1 << 40, "PoW grind failed (astronomically unlikely)"


def _pow_grind_host(permute_many, state, witness_pos: int, pow_bits: int,
                    batch: int) -> int:
    """Grind through a host batch permutation uint64 [n, 12] -> [n, 12]:
    the smallest witness whose response's top `pow_bits` bits are 0 (with
    0 bits, witness 0)."""
    if pow_bits == 0:
        return 0
    base = np.asarray(state, dtype=np.uint64)
    shift = np.uint64(64 - pow_bits)
    start = 0
    while True:
        states = np.tile(base, (batch, 1))
        states[:, witness_pos] = start + np.arange(batch, dtype=np.uint64)
        out = permute_many(states)
        hits = np.nonzero(out[:, SPONGE_RATE - 1] >> shift == 0)[0]
        if len(hits):
            return start + int(hits[0])
        start += batch
        assert start < 1 << 40, "PoW grind failed (astronomically unlikely)"


def fri_proof_of_work(challenger: Challenger, pow_bits: int, device) -> int:
    """Find the smallest witness w whose duplex response has >= pow_bits
    leading zeros. A device hasher (Poseidon, Poseidon2) on a GPU runs the
    wave through its permutation kernel; otherwise the grind runs through
    the hasher's host batch permutation: the C loops of `host.py` (the
    Poseidon family on a CPU, as the JAX prover does there; PoseidonBN128,
    threaded) or Keccak's numpy onion, on every device."""
    hasher = challenger.hasher
    state = list(challenger.sponge_state)
    witness_pos = len(challenger.input_buffer)
    for i, x in enumerate(challenger.input_buffer):
        state[i] = x
    threshold = 1 << (64 - pow_bits)
    if hasher.device and torch.device(device).type == "cuda":
        witness = _pow_wave(hasher.permute, state, witness_pos, pow_bits,
                            max(256, min(1 << 20, 8 << pow_bits)), device)
    else:
        witness = _pow_grind_host(hasher.permute_many_host, state,
                                  witness_pos, pow_bits,
                                  max(256, min(1 << 16, 2 << pow_bits)))
    challenger.observe_element(witness)
    response = challenger.get_challenge()
    if response >= threshold:
        raise RuntimeError(
            f"PoW witness {witness} gives response {response:#x} on the "
            f"host, not below {threshold:#x}: the {hasher.name} grind on "
            f"{device} disagrees with the host permutation")
    return witness


def fri_prover_query_rounds(initial_trees, trees, challenger: Challenger,
                            n: int, fri_params: FriParams):
    indices = [c % n for c in
               challenger.get_n_challenges(fri_params.config.num_query_rounds)]
    init_rows = [t.rows_batch(indices) for t in initial_trees]
    init_paths = [t.prove_batch(indices) for t in initial_trees]
    step_rows, step_paths = [], []
    cur = np.asarray(indices, dtype=np.int64)
    for tree, arity_bits in zip(trees, fri_params.reduction_arity_bits):
        cur = cur >> arity_bits
        step_rows.append(tree.rows_batch(cur))
        step_paths.append(tree.prove_batch(cur))
    rounds = []
    for q in range(len(indices)):
        initial = [(init_rows[t][q], init_paths[t][q])
                   for t in range(len(initial_trees))]
        steps = []
        for rows, paths in zip(step_rows, step_paths):
            row = rows[q]
            evals = [(int(row[2 * j]), int(row[2 * j + 1]))
                     for j in range(len(row) // 2)]
            steps.append(FriQueryStep(evals=evals, merkle_proof=paths[q]))
        rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(evals_proofs=initial),
            steps=steps))
    return rounds


def fri_proof(initial_trees, lde_coeffs: GF2, lde_values: GF2,
              challenger: Challenger, fri_params: FriParams) -> FriProof:
    n = lde_values.shape[-1]
    device = lde_values.c0.device
    with tracing.scope("fold codewords in the commitment phase", device):
        trees, final_coeffs = fri_committed_trees(lde_coeffs, lde_values,
                                                  challenger, fri_params)
    with tracing.scope("find proof-of-work witness", device):
        pow_witness = fri_proof_of_work(
            challenger, fri_params.config.proof_of_work_bits, device)
    with tracing.scope("FRI query rounds", device):
        query_rounds = fri_prover_query_rounds(initial_trees, trees,
                                               challenger, n, fri_params)
    return FriProof(
        commit_phase_merkle_caps=[t.cap_digests() for t in trees],
        query_round_proofs=query_rounds,
        final_poly=final_coeffs,
        pow_witness=pow_witness,
    )
