"""Compressed PLONK proofs.

Reference: plonky2/src/plonk/proof.rs — Proof::compress (:58-78),
CompressedProof (:132-174), CompressedProofWithPublicInputs (:176-240);
get_inferred_elements (plonk/get_challenges.rs:180-251).

Compression is lossless given the transcript: duplicate FRI query indices are
deduplicated, shared Merkle-path nodes dropped, and the fold evaluation the
verifier can infer is removed. Decompression replays the Fiat-Shamir
transcript to recover the dropped data.
"""

from __future__ import annotations

import dataclasses

from ..field import reference as ref
from ..fri.compressed import (
    CompressedFriProof, compress_fri_proof, decompress_fri_proof,
)
from ..fri.verifier import (
    _reduce_rev, compute_evaluation, fri_combine_initial,
)
from ..utils.bits import reverse_bits
from .get_challenges import get_challenges
from .proof import OpeningSet, Proof, ProofWithPublicInputs


@dataclasses.dataclass
class CompressedProof:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: OpeningSet
    opening_proof: CompressedFriProof


@dataclasses.dataclass
class CompressedProofWithPublicInputs:
    proof: CompressedProof
    public_inputs: list[int]


def compress_proof(proof_with_pis: ProofWithPublicInputs, circuit_digest,
                   common) -> CompressedProofWithPublicInputs:
    """reference: proof.rs:91-101."""
    pi_hash = common.gc.hash_public_inputs(
        [x % ref.ORDER for x in proof_with_pis.public_inputs])
    challenges = get_challenges(proof_with_pis, pi_hash, circuit_digest,
                                common)
    indices = challenges.fri_challenges.fri_query_indices
    p = proof_with_pis.proof
    return CompressedProofWithPublicInputs(
        proof=CompressedProof(
            wires_cap=p.wires_cap,
            plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
            quotient_polys_cap=p.quotient_polys_cap,
            openings=p.openings,
            opening_proof=compress_fri_proof(p.opening_proof, indices,
                                             common.fri_params,
                                             common.gc.hasher)),
        public_inputs=list(proof_with_pis.public_inputs))


def _get_inferred_elements(compressed: CompressedProofWithPublicInputs,
                           challenges, common) -> list:
    """Simulate FRI query verification to recover the dropped evals
    (reference: get_challenges.rs:180-251)."""
    zeta = challenges.plonk_zeta
    fri = challenges.fri_challenges
    params = common.fri_params
    instance = common.get_fri_instance(zeta)
    openings = compressed.proof.openings.to_fri_openings()
    reduced_openings = [_reduce_rev(b.values, fri.fri_alpha)
                        for b in openings.batches]
    log_n = common.degree_bits + common.config.fri_config.rate_bits
    inferred = []
    seen_by_depth = [set() for _ in params.reduction_arity_bits]
    for x_index in fri.fri_query_indices:
        subgroup_x = ref.mul(
            ref.MULTIPLICATIVE_GROUP_GENERATOR,
            ref.exp(ref.primitive_root_of_unity(log_n),
                    reverse_bits(x_index, log_n)))
        old_eval = fri_combine_initial(
            instance,
            compressed.proof.opening_proof.query_round_proofs
            .initial_trees_proofs[x_index],
            fri.fri_alpha, subgroup_x, reduced_openings, params)
        for i, arity_bits in enumerate(params.reduction_arity_bits):
            coset_index = x_index >> arity_bits
            if coset_index in seen_by_depth[i]:
                break
            seen_by_depth[i].add(coset_index)
            inferred.append(old_eval)
            arity = 1 << arity_bits
            within = x_index & (arity - 1)
            evals = [tuple(e) for e in compressed.proof.opening_proof
                     .query_round_proofs.steps[i][coset_index].evals]
            evals.insert(within, tuple(old_eval))
            old_eval = compute_evaluation(subgroup_x, within, arity_bits,
                                          evals, fri.fri_betas[i])
            subgroup_x = ref.exp(subgroup_x, arity)
            x_index = coset_index
    return inferred


def decompress_proof(compressed: CompressedProofWithPublicInputs,
                     circuit_digest, common) -> ProofWithPublicInputs:
    """reference: proof.rs:188-203."""
    pi_hash = common.gc.hash_public_inputs(
        [x % ref.ORDER for x in compressed.public_inputs])
    challenges = get_challenges(compressed, pi_hash, circuit_digest, common)
    inferred = _get_inferred_elements(compressed, challenges, common)
    p = compressed.proof
    return ProofWithPublicInputs(
        proof=Proof(
            wires_cap=p.wires_cap,
            plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
            quotient_polys_cap=p.quotient_polys_cap,
            openings=p.openings,
            opening_proof=decompress_fri_proof(
                p.opening_proof, challenges.fri_challenges.fri_query_indices,
                inferred, common.fri_params, common.gc.hasher)),
        public_inputs=list(compressed.public_inputs))
