"""Recursive STARK verification: embed a STARK verifier inside a plonky2
circuit.

Reference: starky/src/recursive_verifier.rs — verify_stark_proof_circuit
(:37-90), verify_stark_proof_with_challenges_circuit (:92-216),
add_virtual_stark_proof[_with_pis] (:219-320), set_stark_proof_with_pis_target
(:322-404).

The constraint evaluation reuses the SAME algebra-generic Stark.eval (and
lookup/CTL evaluators) as the native prover/verifier, instantiated with
TargetAlgebra — the reference's hand-written eval_ext_circuit per STARK is
obtained for free, with constraint-order identity by construction.
"""

from __future__ import annotations

import dataclasses

from ..field import reference as ref
from ..fri.structure import FriOracleInfo, FriPolynomialInfo
from ..gadgets.misc import ReducingFactorTarget
from ..gates.target_algebra import TargetAlgebra
from ..iop.recursive_challenger import RecursiveChallenger
from ..recursion.targets import (
    FriProofTarget, _add_cap, _set_cap, _set_ext, add_virtual_fri_proof,
    set_fri_proof_target,
)
from ..recursion.fri_verifier import verify_fri_proof_circuit
from .cross_table_lookup import eval_cross_table_lookup_checks
from .lookup import eval_lookups
from .stark import ConstraintConsumer, EvaluationFrame, Stark


@dataclasses.dataclass
class StarkOpeningSetTarget:
    local_values: list
    next_values: list
    quotient_polys: list
    auxiliary_polys: list | None = None
    auxiliary_polys_next: list | None = None
    ctl_zs_first: list | None = None

    def to_fri_openings(self, builder):
        """All batches as ExtTargets; ctl_zs_first base targets are lifted
        (reference: proof.rs StarkOpeningSetTarget::to_fri_openings)."""
        aux = self.auxiliary_polys or []
        aux_next = self.auxiliary_polys_next or []
        batches = [list(self.local_values) + aux + list(self.quotient_polys),
                   list(self.next_values) + aux_next]
        if self.ctl_zs_first is not None:
            batches.append([builder.convert_to_ext(t)
                            for t in self.ctl_zs_first])
        return batches


@dataclasses.dataclass
class StarkProofTarget:
    trace_cap: list
    quotient_polys_cap: list
    openings: StarkOpeningSetTarget
    opening_proof: FriProofTarget
    auxiliary_polys_cap: list | None = None


@dataclasses.dataclass
class StarkProofWithPublicInputsTarget:
    proof: StarkProofTarget
    public_inputs: list


def add_virtual_stark_proof_with_pis(builder, stark: Stark, config,
                                     degree_bits: int,
                                     num_ctl_helpers: int = 0,
                                     num_ctl_zs: int = 0
                                     ) -> StarkProofWithPublicInputsTarget:
    """reference: recursive_verifier.rs:219-320."""
    fri_params = config.fri_params(degree_bits)
    cap_height = config.fri_config.cap_height

    def ext():
        return builder.add_virtual_extension_target()

    num_lk = stark.num_lookup_helper_columns(config)
    num_aux = num_lk + num_ctl_helpers + num_ctl_zs
    has_aux = stark.uses_lookups() or stark.requires_ctls()
    num_quotient = stark.num_quotient_polys(config)

    openings = StarkOpeningSetTarget(
        local_values=[ext() for _ in range(stark.COLUMNS)],
        next_values=[ext() for _ in range(stark.COLUMNS)],
        quotient_polys=[ext() for _ in range(num_quotient)],
        auxiliary_polys=[ext() for _ in range(num_aux)] if has_aux else None,
        auxiliary_polys_next=([ext() for _ in range(num_aux)]
                              if has_aux else None),
        ctl_zs_first=(builder.add_virtual_targets(num_ctl_zs)
                      if stark.requires_ctls() else None),
    )

    num_leaves_per_oracle = [stark.COLUMNS]
    if has_aux:
        num_leaves_per_oracle.append(num_aux)
    num_leaves_per_oracle.append(num_quotient)

    opening_proof = add_virtual_fri_proof(builder, fri_params,
                                          num_leaves_per_oracle)

    proof = StarkProofTarget(
        trace_cap=_add_cap(builder, cap_height),
        quotient_polys_cap=_add_cap(builder, cap_height),
        openings=openings,
        opening_proof=opening_proof,
        auxiliary_polys_cap=_add_cap(builder, cap_height) if has_aux else None,
    )
    return StarkProofWithPublicInputsTarget(
        proof=proof,
        public_inputs=builder.add_virtual_targets(stark.PUBLIC_INPUTS))


def set_stark_proof_with_pis_target(pw, pt: StarkProofWithPublicInputsTarget,
                                    proof_with_pis) -> None:
    """reference: recursive_verifier.rs:322-404."""
    proof = proof_with_pis.proof
    for t, v in zip(pt.public_inputs, proof_with_pis.public_inputs):
        pw.set_target(t, int(v))
    _set_cap(pw, pt.proof.trace_cap, proof.trace_cap)
    _set_cap(pw, pt.proof.quotient_polys_cap, proof.quotient_polys_cap)
    if pt.proof.auxiliary_polys_cap is not None:
        _set_cap(pw, pt.proof.auxiliary_polys_cap, proof.auxiliary_polys_cap)

    o, ot = proof.openings, pt.proof.openings
    for ts, vs in [(ot.local_values, o.local_values),
                   (ot.next_values, o.next_values),
                   (ot.quotient_polys, o.quotient_polys),
                   (ot.auxiliary_polys or [], o.auxiliary_polys or []),
                   (ot.auxiliary_polys_next or [],
                    o.auxiliary_polys_next or [])]:
        for t, v in zip(ts, vs):
            _set_ext(pw, t, v)
    if ot.ctl_zs_first is not None:
        for t, v in zip(ot.ctl_zs_first, o.ctl_zs_first):
            pw.set_target(t, int(v))
    set_fri_proof_target(pw, pt.proof.opening_proof, proof.opening_proof)


@dataclasses.dataclass(frozen=True)
class _BatchT:
    point: object
    polynomials: tuple


@dataclasses.dataclass(frozen=True)
class _InstanceT:
    oracles: tuple
    batches: tuple


def _stark_fri_instance_target(builder, stark, zeta, g: int, config,
                               num_ctl_helpers: int, num_ctl_zs: int):
    """reference: stark.rs fri_instance_target:174-246."""
    oracles = []
    trace_info = FriPolynomialInfo.from_range(0, 0, stark.COLUMNS)
    oracles.append(FriOracleInfo(num_polys=stark.COLUMNS, blinding=False))
    num_lk = stark.num_lookup_helper_columns(config)
    num_aux = num_lk + num_ctl_helpers + num_ctl_zs
    aux_info = []
    if stark.uses_lookups() or stark.requires_ctls():
        aux_info = FriPolynomialInfo.from_range(len(oracles), 0, num_aux)
        oracles.append(FriOracleInfo(num_polys=num_aux, blinding=False))
    num_quotient = stark.num_quotient_polys(config)
    quotient_info = FriPolynomialInfo.from_range(len(oracles), 0,
                                                 num_quotient)
    oracles.append(FriOracleInfo(num_polys=num_quotient, blinding=False))

    zeta_next = builder.mul_const_extension(g, zeta)
    batches = [
        _BatchT(point=zeta,
                polynomials=tuple(trace_info + aux_info + quotient_info)),
        _BatchT(point=zeta_next, polynomials=tuple(trace_info + aux_info)),
    ]
    if stark.requires_ctls():
        ctl_zs_info = FriPolynomialInfo.from_range(
            1, num_lk + num_ctl_helpers, num_aux)
        batches.append(_BatchT(point=builder.one_extension(),
                               polynomials=tuple(ctl_zs_info)))
    return _InstanceT(oracles=tuple(oracles), batches=tuple(batches))


def verify_stark_proof_circuit(builder, stark: Stark,
                               pt: StarkProofWithPublicInputsTarget,
                               config, degree_bits: int,
                               ctl_vars=None, ctl_challenges_t=None,
                               num_ctl_helpers: int = 0,
                               num_ctl_zs: int = 0) -> None:
    """In-circuit STARK verification
    (reference: recursive_verifier.rs:37-216)."""
    assert len(pt.public_inputs) == stark.PUBLIC_INPUTS
    proof = pt.proof
    nc = config.num_challenges

    # challenge replay (reference: starky get_challenges.rs target version)
    ch = RecursiveChallenger(builder)
    ch.observe_cap(proof.trace_cap)
    lookup_challenges = None
    if stark.uses_lookups():
        if ctl_challenges_t is not None:
            lookup_challenges = [b for b, _g in ctl_challenges_t]
        else:
            lookup_challenges = []
            for _ in range(nc):
                beta = ch.get_challenge()
                _gamma = ch.get_challenge()
                lookup_challenges.append(beta)
    if proof.auxiliary_polys_cap is not None:
        ch.observe_cap(proof.auxiliary_polys_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_polys_cap)
    zeta = ch.get_extension_challenge()
    openings_batches = proof.openings.to_fri_openings(builder)
    for batch in openings_batches:
        ch.observe_extension_elements(batch)
    fri_alpha = ch.get_extension_challenge()
    fri_betas = []
    for cap in proof.opening_proof.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    ch.observe_extension_elements(proof.opening_proof.final_poly)
    ch.observe_element(proof.opening_proof.pow_witness)
    fri_pow_response = ch.get_challenge()
    fri_query_indices = ch.get_n_challenges(
        config.fri_config.num_query_rounds)
    challenges = {
        "fri_alpha": fri_alpha, "fri_betas": fri_betas,
        "fri_pow_response": fri_pow_response,
        "fri_query_indices": fri_query_indices,
    }

    # constraint evaluation at zeta via TargetAlgebra
    alg = TargetAlgebra(builder)
    one = builder.one_extension()
    g = ref.primitive_root_of_unity(degree_bits)
    degree = 1 << degree_bits
    zeta_pow_deg = builder.exp_power_of_2_extension(zeta, degree_bits)
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    n_e = degree % ref.ORDER
    denom_first = builder.mul_const_extension(
        n_e, builder.sub_extension(zeta, one))
    l_first = builder.div_extension(z_h_zeta, denom_first)
    gz = builder.mul_const_extension(g, zeta)
    denom_last = builder.mul_const_extension(
        n_e, builder.sub_extension(gz, one))
    l_last = builder.div_extension(z_h_zeta, denom_last)
    last = ref.inverse(g)
    z_last = builder.sub_extension(
        zeta, builder.constant_extension((last, 0)))

    lift = builder.convert_to_ext
    o = proof.openings
    frame = EvaluationFrame(list(o.local_values), list(o.next_values),
                            [lift(p) for p in pt.public_inputs])
    consumer = ConstraintConsumer(alg, [lift(a) for a in alphas],
                                  z_last, l_first, l_last)
    stark.eval(alg, frame, consumer)
    num_lk = stark.num_lookup_helper_columns(config)
    if stark.uses_lookups():
        eval_lookups(alg, stark, stark.lookups(), list(o.local_values),
                     list(o.next_values), o.auxiliary_polys[:num_lk],
                     o.auxiliary_polys_next[:num_lk],
                     [lift(c) for c in lookup_challenges], consumer)
    if ctl_vars is not None:
        eval_cross_table_lookup_checks(
            alg, list(o.local_values), list(o.next_values), ctl_vars,
            consumer, max(2, stark.constraint_degree()))
    vanishing = consumer.accs

    qdf = stark.quotient_degree_factor()
    for i in range(nc):
        chunk = o.quotient_polys[i * qdf:(i + 1) * qdf]
        scale = ReducingFactorTarget(zeta_pow_deg)
        recombined = scale.reduce(chunk, builder)
        computed = builder.mul_extension(z_h_zeta, recombined)
        builder.connect_extension(vanishing[i], computed)

    merkle_caps = [proof.trace_cap]
    if proof.auxiliary_polys_cap is not None:
        merkle_caps.append(proof.auxiliary_polys_cap)
    merkle_caps.append(proof.quotient_polys_cap)

    instance = _stark_fri_instance_target(builder, stark, zeta, g, config,
                                          num_ctl_helpers, num_ctl_zs)
    verify_fri_proof_circuit(
        builder, instance, openings_batches, challenges,
        merkle_caps, proof.opening_proof, config.fri_params(degree_bits))
