"""PLONK verifier — host-side, polylog work (plonky2_tpu/plonk/verifier.py;
reference: plonky2/src/plonk/verifier.rs:17-120)."""

from __future__ import annotations

from ..field import reference as ref
from ..fri.verifier import verify_fri_proof
from .circuit_data import CommonCircuitData, VerifierOnlyData
from .get_challenges import get_challenges
from .proof import ProofWithPublicInputs
from .validate_shape import validate_proof_with_pis_shape
from .vanishing import eval_vanishing_poly_at_zeta


def verify(proof_with_pis: ProofWithPublicInputs,
           verifier_data: VerifierOnlyData,
           common: CommonCircuitData) -> None:
    validate_proof_with_pis_shape(proof_with_pis, common)
    proof = proof_with_pis.proof
    public_inputs_hash = common.gc.hash_public_inputs(
        [x % ref.ORDER for x in proof_with_pis.public_inputs])
    challenges = get_challenges(proof_with_pis, public_inputs_hash,
                                verifier_data.circuit_digest, common)

    vanishing_zeta = eval_vanishing_poly_at_zeta(
        common, challenges.plonk_zeta, proof.openings, public_inputs_hash,
        challenges.plonk_betas, challenges.plonk_gammas,
        challenges.plonk_alphas)

    # vanishing(zeta) == Z_H(zeta) * t(zeta), with t reassembled from its
    # degree-n chunks by powers of zeta^n (reference: verifier.rs:78-95)
    zeta_pow_deg = ref.ext2_exp(challenges.plonk_zeta, common.degree)
    z_h_zeta = ref.ext2_sub(zeta_pow_deg, (1, 0))
    qdf = common.quotient_degree_factor
    for i in range(common.config.num_challenges):
        chunk = proof.openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = (0, 0)
        for c in reversed(chunk):
            acc = ref.ext2_add(ref.ext2_mul(acc, zeta_pow_deg), tuple(c))
        lhs = vanishing_zeta[i]
        rhs = ref.ext2_mul(z_h_zeta, acc)
        assert tuple(lhs) == tuple(rhs), \
            f"vanishing-poly identity failed for challenge {i}"

    merkle_caps = [
        verifier_data.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    verify_fri_proof(
        common.get_fri_instance(challenges.plonk_zeta),
        proof.openings.to_fri_openings(),
        challenges.fri_challenges,
        merkle_caps,
        proof.opening_proof,
        common.fri_params,
        hasher=common.gc.hasher,
    )
