"""Virtual proof targets + witness filling.

Reference: plonky2/src/recursion/recursive_verifier.rs:140-230
(add_virtual_proof_with_pis), fri/recursive_verifier.rs:418-470
(add_virtual_fri_proof), fri/witness_util.rs (set_fri_proof_target).
"""

from __future__ import annotations

import dataclasses

from ..iop.target import ExtTarget
from ..plonk.circuit_data import CommonCircuitData


@dataclasses.dataclass
class FriInitialTreeProofTarget:
    evals_proofs: list  # per oracle: (list[Target] evals, list[hash4] siblings)

    def unsalted_eval(self, oracle_index, poly_index, salted):
        evals = self.evals_proofs[oracle_index][0]
        return evals[poly_index]


@dataclasses.dataclass
class FriQueryStepTarget:
    evals: list          # [arity] ExtTarget
    merkle_proof: list   # [levels] of 4-target hashes


@dataclasses.dataclass
class FriQueryRoundTarget:
    initial_trees_proof: FriInitialTreeProofTarget
    steps: list


@dataclasses.dataclass
class FriProofTarget:
    commit_phase_merkle_caps: list  # [layers][2^cap][4]
    query_round_proofs: list
    final_poly: list                # [len] ExtTarget
    pow_witness: object


@dataclasses.dataclass
class OpeningSetTarget:
    constants: list
    plonk_sigmas: list
    wires: list
    plonk_zs: list
    plonk_zs_next: list
    partial_products: list
    quotient_polys: list

    def to_fri_openings(self):
        zeta_batch = (self.constants + self.plonk_sigmas + self.wires
                      + self.plonk_zs + self.partial_products
                      + self.quotient_polys)
        return [zeta_batch, list(self.plonk_zs_next)]


@dataclasses.dataclass
class ProofTarget:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: OpeningSetTarget
    opening_proof: FriProofTarget


@dataclasses.dataclass
class ProofWithPublicInputsTarget:
    proof: ProofTarget
    public_inputs: list


@dataclasses.dataclass
class VerifierCircuitTarget:
    constants_sigmas_cap: list
    circuit_digest: list


def _add_cap(builder, cap_height):
    return [builder.add_virtual_targets(4) for _ in range(1 << cap_height)]


def add_virtual_fri_proof(builder, fri_params,
                          num_leaves_per_oracle) -> FriProofTarget:
    """FRI proof targets for any oracle layout
    (reference: fri/recursive_verifier.rs:418-470)."""
    cap_height = fri_params.config.cap_height

    def ext():
        return builder.add_virtual_extension_target()

    merkle_proof_len0 = fri_params.lde_bits - cap_height
    query_rounds = []
    for _ in range(fri_params.config.num_query_rounds):
        evals_proofs = []
        for n_leaves in num_leaves_per_oracle:
            evals = builder.add_virtual_targets(n_leaves)
            sibs = [builder.add_virtual_targets(4)
                    for _ in range(merkle_proof_len0)]
            evals_proofs.append((evals, sibs))
        steps = []
        mp_len = merkle_proof_len0
        for arity_bits in fri_params.reduction_arity_bits:
            mp_len -= arity_bits
            steps.append(FriQueryStepTarget(
                evals=[ext() for _ in range(1 << arity_bits)],
                merkle_proof=[builder.add_virtual_targets(4)
                              for _ in range(mp_len)]))
        query_rounds.append(FriQueryRoundTarget(
            initial_trees_proof=FriInitialTreeProofTarget(evals_proofs),
            steps=steps))

    return FriProofTarget(
        commit_phase_merkle_caps=[
            _add_cap(builder, cap_height)
            for _ in fri_params.reduction_arity_bits],
        query_round_proofs=query_rounds,
        final_poly=[ext() for _ in range(fri_params.final_poly_len)],
        pow_witness=builder.add_virtual_target(),
    )


def add_virtual_proof_with_pis(builder, common: CommonCircuitData
                               ) -> ProofWithPublicInputsTarget:
    fri_params = common.fri_params
    cap_height = fri_params.config.cap_height
    num_leaves_per_oracle = [
        common.num_preprocessed_polys,
        common.config.num_wires,
        common.num_zs_partial_products_polys,
        common.num_quotient_polys,
    ]

    def ext():
        return builder.add_virtual_extension_target()

    openings = OpeningSetTarget(
        constants=[ext() for _ in common.constants_range],
        plonk_sigmas=[ext() for _ in common.sigmas_range],
        wires=[ext() for _ in range(common.config.num_wires)],
        plonk_zs=[ext() for _ in common.zs_range],
        plonk_zs_next=[ext() for _ in common.zs_range],
        partial_products=[ext() for _ in common.partial_products_range],
        quotient_polys=[ext() for _ in range(common.num_quotient_polys)],
    )

    opening_proof = add_virtual_fri_proof(builder, fri_params,
                                          num_leaves_per_oracle)

    proof = ProofTarget(
        wires_cap=_add_cap(builder, cap_height),
        plonk_zs_partial_products_cap=_add_cap(builder, cap_height),
        quotient_polys_cap=_add_cap(builder, cap_height),
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputsTarget(
        proof=proof,
        public_inputs=builder.add_virtual_targets(common.num_public_inputs))


def add_virtual_verifier_data(builder, cap_height) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(
        constants_sigmas_cap=_add_cap(builder, cap_height),
        circuit_digest=builder.add_virtual_targets(4))


# ---------------------------------------------------------------------------
# Witness filling (reference: fri/witness_util.rs, recursion tests)
# ---------------------------------------------------------------------------

def set_proof_with_pis_target(pw, pt: ProofWithPublicInputsTarget,
                              proof_with_pis) -> None:
    proof = proof_with_pis.proof
    for t, v in zip(pt.public_inputs, proof_with_pis.public_inputs):
        pw.set_target(t, int(v))
    _set_cap(pw, pt.proof.wires_cap, proof.wires_cap)
    _set_cap(pw, pt.proof.plonk_zs_partial_products_cap,
             proof.plonk_zs_partial_products_cap)
    _set_cap(pw, pt.proof.quotient_polys_cap, proof.quotient_polys_cap)

    o, ot = proof.openings, pt.proof.openings
    for ts, vs in [(ot.constants, o.constants), (ot.plonk_sigmas, o.plonk_sigmas),
                   (ot.wires, o.wires), (ot.plonk_zs, o.plonk_zs),
                   (ot.plonk_zs_next, o.plonk_zs_next),
                   (ot.partial_products, o.partial_products),
                   (ot.quotient_polys, o.quotient_polys)]:
        for t, v in zip(ts, vs):
            _set_ext(pw, t, v)

    set_fri_proof_target(pw, pt.proof.opening_proof, proof.opening_proof)


def set_fri_proof_target(pw, fpt: FriProofTarget, fp) -> None:
    """reference: fri/witness_util.rs set_fri_proof_target."""
    for cap_t, cap_v in zip(fpt.commit_phase_merkle_caps,
                            fp.commit_phase_merkle_caps):
        _set_cap(pw, cap_t, cap_v)
    for t, v in zip(fpt.final_poly, fp.final_poly):
        _set_ext(pw, t, v)
    pw.set_target(fpt.pow_witness, int(fp.pow_witness))

    for qt, qv in zip(fpt.query_round_proofs, fp.query_round_proofs):
        for (evals_t, sibs_t), (evals_v, sibs_v) in zip(
                qt.initial_trees_proof.evals_proofs,
                qv.initial_trees_proof.evals_proofs):
            for t, v in zip(evals_t, evals_v):
                pw.set_target(t, int(v))
            for h_t, h_v in zip(sibs_t, sibs_v):
                for t, v in zip(h_t, h_v):
                    pw.set_target(t, int(v))
        for st, sv in zip(qt.steps, qv.steps):
            for t, v in zip(st.evals, sv.evals):
                _set_ext(pw, t, v)
            for h_t, h_v in zip(st.merkle_proof, sv.merkle_proof):
                for t, v in zip(h_t, h_v):
                    pw.set_target(t, int(v))


def set_verifier_data_target(pw, vt: VerifierCircuitTarget,
                             verifier_data) -> None:
    _set_cap(pw, vt.constants_sigmas_cap, verifier_data.constants_sigmas_cap)
    for t, v in zip(vt.circuit_digest, verifier_data.circuit_digest):
        pw.set_target(t, int(v))


def _set_cap(pw, cap_t, cap_v):
    for h_t, h_v in zip(cap_t, cap_v):
        for t, v in zip(h_t, h_v):
            pw.set_target(t, int(v))


def _set_ext(pw, t: ExtTarget, v):
    pw.set_target(t[0], int(v[0]))
    pw.set_target(t[1], int(v[1]))
