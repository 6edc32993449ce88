"""Compressed FRI proofs: shared Merkle-path nodes removed, duplicate query
indices deduplicated, inferable fold evaluations dropped.

Reference: plonky2/src/fri/proof.rs — CompressedFriQueryRounds (:94-123),
CompressedFriProof (:125-135), FriProof::compress (:137-236),
CompressedFriProof::decompress (:238-362). Digests (caps, siblings) are the
hasher's host digests: tuples of 4 ints, or bytes under Keccak.
"""

from __future__ import annotations

import dataclasses

from ..hash.path_compression import (
    compress_merkle_proofs, decompress_merkle_proofs,
)
from .config import FriParams
from .proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep


@dataclasses.dataclass
class CompressedFriQueryRounds:
    indices: list[int]
    initial_trees_proofs: dict      # index -> FriInitialTreeProof
    steps: list         # per reduction: dict coset_index -> FriQueryStep


@dataclasses.dataclass
class CompressedFriProof:
    commit_phase_merkle_caps: list
    query_round_proofs: CompressedFriQueryRounds
    final_poly: list
    pow_witness: int


def _flatten_ext(evals):
    return [int(c) for e in evals for c in e]


def compress_fri_proof(proof: FriProof, indices, params: FriParams,
                       hasher) -> CompressedFriProof:
    """reference: fri/proof.rs:137-236."""
    cap_height = params.config.cap_height
    rab = params.reduction_arity_bits
    num_reductions = len(rab)
    num_initial = len(proof.query_round_proofs[0]
                      .initial_trees_proof.evals_proofs)

    it_indices = [[] for _ in range(num_initial)]
    it_proofs = [[] for _ in range(num_initial)]
    st_indices = [[] for _ in range(num_reductions)]
    st_evals = [[] for _ in range(num_reductions)]
    st_proofs = [[] for _ in range(num_reductions)]

    per_round_initial = []
    per_round_steps = []
    for index, qrp in zip(indices, proof.query_round_proofs):
        for i, (leaves, prf) in enumerate(
                qrp.initial_trees_proof.evals_proofs):
            it_indices[i].append(index)
            it_proofs[i].append(list(prf))
        per_round_initial.append(qrp.initial_trees_proof)
        steps = []
        for i, step in enumerate(qrp.steps):
            within = index & ((1 << rab[i]) - 1)
            index >>= rab[i]
            st_indices[i].append(index)
            evals = [tuple(e) for e in step.evals]
            evals.pop(within)       # the verifier can infer this element
            st_evals[i].append(evals)
            st_proofs[i].append(list(step.merkle_proof))
            steps.append(None)
        per_round_steps.append(steps)

    it_proofs = [compress_merkle_proofs(cap_height, idxs, ps, hasher)
                 for idxs, ps in zip(it_indices, it_proofs)]
    st_proofs = [compress_merkle_proofs(cap_height, idxs, ps, hasher)
                 for idxs, ps in zip(st_indices, st_proofs)]

    out = CompressedFriQueryRounds(indices=list(indices),
                                   initial_trees_proofs={},
                                   steps=[{} for _ in range(num_reductions)])
    for i, index in enumerate(indices):
        initial = FriInitialTreeProof(evals_proofs=[
            ([int(x) for x in per_round_initial[i].evals_proofs[j][0]],
             it_proofs[j][i])
            for j in range(num_initial)])
        out.initial_trees_proofs.setdefault(index, initial)
        for j in range(num_reductions):
            index >>= rab[j]
            step = FriQueryStep(evals=st_evals[j][i],
                                merkle_proof=st_proofs[j][i])
            out.steps[j].setdefault(index, step)

    return CompressedFriProof(
        commit_phase_merkle_caps=[[hasher.digest_from_row(h) for h in cap]
                                  for cap in proof.commit_phase_merkle_caps],
        query_round_proofs=out,
        final_poly=[tuple(c) for c in proof.final_poly],
        pow_witness=int(proof.pow_witness))


def decompress_fri_proof(compressed: CompressedFriProof,
                         fri_query_indices, fri_inferred_elements,
                         params: FriParams, hasher) -> FriProof:
    """reference: fri/proof.rs:238-362."""
    cap_height = params.config.cap_height
    rab = params.reduction_arity_bits
    num_reductions = len(rab)
    qrp = compressed.query_round_proofs
    num_initial = len(next(iter(qrp.initial_trees_proofs.values()))
                      .evals_proofs)
    inferred = iter(fri_inferred_elements)

    it_indices = [[] for _ in range(num_initial)]
    it_leaves = [[] for _ in range(num_initial)]
    it_proofs = [[] for _ in range(num_initial)]
    st_indices = [[] for _ in range(num_reductions)]
    st_evals = [[] for _ in range(num_reductions)]
    st_proofs = [[] for _ in range(num_reductions)]
    height = params.degree_bits + params.config.rate_bits
    heights = []
    h = height
    for bits in rab:
        h -= bits
        heights.append(h)

    evals_by_depth = [{} for _ in range(num_reductions)]
    for index in fri_query_indices:
        initial = qrp.initial_trees_proofs[index]
        for i, (leaves, prf) in enumerate(initial.evals_proofs):
            it_indices[i].append(index)
            it_leaves[i].append([int(x) for x in leaves])
            it_proofs[i].append(prf)
        for i in range(num_reductions):
            within = index & ((1 << rab[i]) - 1)
            index >>= rab[i]
            step = qrp.steps[i][index]
            st_indices[i].append(index)
            if index in evals_by_depth[i]:
                evals = evals_by_depth[i][index]
            else:
                evals = [tuple(e) for e in step.evals]
                evals.insert(within, tuple(next(inferred)))
                evals_by_depth[i][index] = evals
            st_evals[i].append(evals)
            st_proofs[i].append(step.merkle_proof)

    it_proofs = [decompress_merkle_proofs(ls, idxs, ps, height, cap_height,
                                          hasher)
                 for ls, idxs, ps in zip(it_leaves, it_indices, it_proofs)]
    st_proofs = [decompress_merkle_proofs(
        [_flatten_ext(e) for e in evs], idxs, ps, hh, cap_height, hasher)
        for evs, idxs, ps, hh in zip(st_evals, st_indices, st_proofs, heights)]

    rounds = []
    for i in range(len(fri_query_indices)):
        initial = FriInitialTreeProof(evals_proofs=[
            (it_leaves[j][i], it_proofs[j][i]) for j in range(num_initial)])
        steps = [FriQueryStep(evals=st_evals[j][i],
                              merkle_proof=st_proofs[j][i])
                 for j in range(num_reductions)]
        rounds.append(FriQueryRound(initial_trees_proof=initial, steps=steps))

    return FriProof(
        commit_phase_merkle_caps=compressed.commit_phase_merkle_caps,
        query_round_proofs=rounds,
        final_poly=compressed.final_poly,
        pow_witness=compressed.pow_witness)
