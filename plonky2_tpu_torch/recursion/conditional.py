"""Conditional recursion: verify one of two proofs, chosen by a boolean
target (reference: plonky2/src/recursion/conditional_recursive_verifier.rs
:24-200). Every component of the two proof targets is selected, then the
selected proof is verified; both proofs must have the same
CommonCircuitData shape."""

from __future__ import annotations

from ..iop.target import ExtTarget
from .targets import (
    FriInitialTreeProofTarget, FriProofTarget, FriQueryRoundTarget,
    FriQueryStepTarget, OpeningSetTarget, ProofTarget,
    ProofWithPublicInputsTarget, VerifierCircuitTarget,
)
from .verifier import verify_proof_circuit


def _sel_ext(builder, b, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ExtTarget(builder.select(b, x[0], y[0]),
                     builder.select(b, x[1], y[1]))


def _sel_vec(builder, b, xs, ys):
    return [builder.select(b, x, y) for x, y in zip(xs, ys)]


def _sel_ext_vec(builder, b, xs, ys):
    return [_sel_ext(builder, b, x, y) for x, y in zip(xs, ys)]


def _sel_cap(builder, b, x, y):
    """A cap or a Merkle path: a list of 4-target hashes."""
    return [_sel_vec(builder, b, hx, hy) for hx, hy in zip(x, y)]


def select_proof_with_pis(builder, b, p0: ProofWithPublicInputsTarget,
                          p1: ProofWithPublicInputsTarget
                          ) -> ProofWithPublicInputsTarget:
    """p0 where b = 1, else p1, component by component in the reference's
    order: openings, query rounds, caps, final poly, PoW witness, public
    inputs."""
    a, c = p0.proof, p1.proof
    o0, o1 = a.openings, c.openings
    openings = OpeningSetTarget(
        constants=_sel_ext_vec(builder, b, o0.constants, o1.constants),
        plonk_sigmas=_sel_ext_vec(builder, b, o0.plonk_sigmas,
                                  o1.plonk_sigmas),
        wires=_sel_ext_vec(builder, b, o0.wires, o1.wires),
        plonk_zs=_sel_ext_vec(builder, b, o0.plonk_zs, o1.plonk_zs),
        plonk_zs_next=_sel_ext_vec(builder, b, o0.plonk_zs_next,
                                   o1.plonk_zs_next),
        partial_products=_sel_ext_vec(builder, b, o0.partial_products,
                                      o1.partial_products),
        quotient_polys=_sel_ext_vec(builder, b, o0.quotient_polys,
                                    o1.quotient_polys),
    )
    f0, f1 = a.opening_proof, c.opening_proof
    query_rounds = []
    for q0, q1 in zip(f0.query_round_proofs, f1.query_round_proofs):
        evals_proofs = [
            (_sel_vec(builder, b, e0, e1), _sel_cap(builder, b, s0, s1))
            for (e0, s0), (e1, s1) in zip(q0.initial_trees_proof.evals_proofs,
                                          q1.initial_trees_proof.evals_proofs)]
        steps = [FriQueryStepTarget(
            evals=_sel_ext_vec(builder, b, st0.evals, st1.evals),
            merkle_proof=_sel_cap(builder, b, st0.merkle_proof,
                                  st1.merkle_proof))
            for st0, st1 in zip(q0.steps, q1.steps)]
        query_rounds.append(FriQueryRoundTarget(
            initial_trees_proof=FriInitialTreeProofTarget(evals_proofs),
            steps=steps))
    opening_proof = FriProofTarget(
        commit_phase_merkle_caps=[
            _sel_cap(builder, b, c0, c1)
            for c0, c1 in zip(f0.commit_phase_merkle_caps,
                              f1.commit_phase_merkle_caps)],
        query_round_proofs=query_rounds,
        final_poly=_sel_ext_vec(builder, b, f0.final_poly, f1.final_poly),
        pow_witness=builder.select(b, f0.pow_witness, f1.pow_witness),
    )
    proof = ProofTarget(
        wires_cap=_sel_cap(builder, b, a.wires_cap, c.wires_cap),
        plonk_zs_partial_products_cap=_sel_cap(
            builder, b, a.plonk_zs_partial_products_cap,
            c.plonk_zs_partial_products_cap),
        quotient_polys_cap=_sel_cap(builder, b, a.quotient_polys_cap,
                                    c.quotient_polys_cap),
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputsTarget(
        proof=proof,
        public_inputs=_sel_vec(builder, b, p0.public_inputs,
                               p1.public_inputs))


def conditionally_verify_proof(builder, condition,
                               proof0: ProofWithPublicInputsTarget,
                               vd0: VerifierCircuitTarget,
                               proof1: ProofWithPublicInputsTarget,
                               vd1: VerifierCircuitTarget,
                               common) -> None:
    """Verify proof0 under vd0 where condition = 1, else proof1 under vd1;
    both are proofs of circuits shaped as `common`."""
    selected = select_proof_with_pis(builder, condition, proof0, proof1)
    vd = VerifierCircuitTarget(
        constants_sigmas_cap=_sel_cap(builder, condition,
                                      vd0.constants_sigmas_cap,
                                      vd1.constants_sigmas_cap),
        circuit_digest=_sel_vec(builder, condition, vd0.circuit_digest,
                                vd1.circuit_digest))
    verify_proof_circuit(builder, selected, vd, common)
