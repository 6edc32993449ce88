"""Verifier-side FRI Fiat-Shamir replay (plonky2_tpu/fri/challenges.py;
reference: plonky2/src/fri/challenges.rs)."""

from __future__ import annotations

from ..iop.challenger import Challenger
from .config import FriConfig
from .proof import FriProof
from .structure import FriChallenges, FriOpenings


def observe_openings(challenger: Challenger, openings: FriOpenings) -> None:
    for batch in openings.batches:
        challenger.observe_extension_elements(batch.values)


def fri_challenges(challenger: Challenger, proof: FriProof,
                   degree_bits: int, config: FriConfig) -> FriChallenges:
    lde_size = 1 << (degree_bits + config.rate_bits)
    fri_alpha = challenger.get_extension_challenge()
    betas = []
    for cap in proof.commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    challenger.observe_extension_elements(proof.final_poly)
    challenger.observe_element(proof.pow_witness)
    pow_response = challenger.get_challenge()
    indices = tuple(challenger.get_challenge() % lde_size
                    for _ in range(config.num_query_rounds))
    return FriChallenges(fri_alpha=fri_alpha, fri_betas=tuple(betas),
                         fri_pow_response=pow_response,
                         fri_query_indices=indices)
