"""Explicit proof-shape validation before any cryptographic work
(reference: plonky2/src/plonk/validate_shape.rs + fri/validate_shape.rs).

A malformed proof must fail with a clear shape error, not a confusing
index error (or worse, silently bind fewer openings than the circuit
demands) deeper in the verifier. Checks are hasher-agnostic: lengths and
counts only, so Poseidon-family (uint64 [4] digests) and byte-digest
(Keccak) configs validate through the same code."""

from __future__ import annotations

from .circuit_data import CommonCircuitData
from .proof import ProofWithPublicInputs


def _check(cond: bool, what: str, got, want) -> None:
    assert cond, f"proof shape: {what}: got {got}, expected {want}"


def _eq(got, want, what: str) -> None:
    _check(got == want, what, got, want)


def validate_proof_with_pis_shape(proof_with_pis: ProofWithPublicInputs,
                                  common: CommonCircuitData) -> None:
    """reference: validate_shape.rs:10-69 validate_proof_with_pis_shape."""
    proof = proof_with_pis.proof
    config = common.config
    fri_params = common.fri_params

    _eq(len(proof_with_pis.public_inputs), common.num_public_inputs,
        "public input count")

    cap_len = fri_params.config.num_cap_elements
    _eq(len(proof.wires_cap), cap_len, "wires cap length")
    _eq(len(proof.plonk_zs_partial_products_cap), cap_len,
        "Z/partial-products cap length")
    _eq(len(proof.quotient_polys_cap), cap_len, "quotient cap length")

    o = proof.openings
    _eq(len(o.constants), common.num_constants, "constants openings")
    _eq(len(o.plonk_sigmas), config.num_routed_wires, "sigma openings")
    _eq(len(o.wires), config.num_wires, "wire openings")
    _eq(len(o.plonk_zs), config.num_challenges, "Z openings")
    _eq(len(o.plonk_zs_next), config.num_challenges, "Z(g·zeta) openings")
    _eq(len(o.partial_products),
        config.num_challenges * common.num_partial_products,
        "partial-product openings")
    _eq(len(o.quotient_polys),
        config.num_challenges * common.quotient_degree_factor,
        "quotient openings")

    validate_fri_proof_shape(proof.opening_proof, common)


def validate_fri_proof_shape(fri_proof, common: CommonCircuitData) -> None:
    """reference: fri/validate_shape.rs:12-69 (instance-driven: every query
    round must open every polynomial of every oracle plus the salt)."""
    fri_params = common.fri_params
    cap_len = fri_params.config.num_cap_elements
    arities = fri_params.reduction_arity_bits

    _eq(len(fri_proof.commit_phase_merkle_caps), len(arities),
        "commit-phase cap count")
    for i, cap in enumerate(fri_proof.commit_phase_merkle_caps):
        _eq(len(cap), cap_len, f"commit-phase cap {i} length")

    # oracle widths come from the circuit's FRI instance (salt included for
    # blinded oracles) — zeta's actual value is irrelevant to shapes
    instance = common.get_fri_instance((1, 0))
    salt = 4 if fri_params.hiding else 0
    widths = [info.num_polys + (salt if info.blinding else 0)
              for info in instance.oracles]

    _eq(len(fri_proof.query_round_proofs),
        fri_params.config.num_query_rounds, "query round count")
    for qi, round_proof in enumerate(fri_proof.query_round_proofs):
        evals_proofs = round_proof.initial_trees_proof.evals_proofs
        _eq(len(evals_proofs), len(widths), f"query {qi}: oracle count")
        for oi, (evals, _proof) in enumerate(evals_proofs):
            _eq(len(evals), widths[oi],
                f"query {qi}: oracle {oi} leaf width")
        _eq(len(round_proof.steps), len(arities),
            f"query {qi}: fold step count")
        for si, step in enumerate(round_proof.steps):
            _eq(len(step.evals), 1 << arities[si],
                f"query {qi}: step {si} coset width")

    _eq(len(fri_proof.final_poly), fri_params.final_poly_len,
        "final polynomial length")
