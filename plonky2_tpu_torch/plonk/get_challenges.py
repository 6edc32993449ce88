"""Fiat-Shamir challenge replay for verification
(plonky2_tpu/plonk/get_challenges.py; reference:
plonky2/src/plonk/get_challenges.rs:25-90)."""

from __future__ import annotations

from ..fri.challenges import fri_challenges, observe_openings
from ..iop.challenger import Challenger
from .circuit_data import CommonCircuitData
from .proof import ProofChallenges, ProofWithPublicInputs


def get_challenges(proof_with_pis: ProofWithPublicInputs,
                   public_inputs_hash: list[int],
                   circuit_digest,
                   common: CommonCircuitData) -> ProofChallenges:
    proof = proof_with_pis.proof
    num_challenges = common.config.num_challenges

    challenger = Challenger(common.gc.hasher)
    challenger.observe_hash(circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(proof.wires_cap)
    plonk_betas = challenger.get_n_challenges(num_challenges)
    plonk_gammas = challenger.get_n_challenges(num_challenges)

    challenger.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = challenger.get_n_challenges(num_challenges)

    challenger.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = challenger.get_extension_challenge()

    observe_openings(challenger, proof.openings.to_fri_openings())

    return ProofChallenges(
        plonk_betas=plonk_betas,
        plonk_gammas=plonk_gammas,
        plonk_alphas=plonk_alphas,
        plonk_zeta=plonk_zeta,
        fri_challenges=fri_challenges(
            challenger, proof.opening_proof, common.degree_bits,
            common.config.fri_config),
    )
