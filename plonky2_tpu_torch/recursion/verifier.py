"""In-circuit PLONK proof verification — the heart of recursion.

Reference: plonky2/src/recursion/recursive_verifier.rs:20-140 (verify_proof),
plonk/get_challenges.rs (target version), plonk/vanishing_poly.rs:693
(eval_vanishing_poly_circuit — here obtained from the SAME generic
eval_vanishing_poly via TargetAlgebra).
"""

from __future__ import annotations

import dataclasses

from ..field import reference as ref
from ..fri.structure import FriOracleInfo, FriPolynomialInfo
from ..gadgets.misc import ReducingFactorTarget
from ..gates.target_algebra import TargetAlgebra
from ..iop.recursive_challenger import RecursiveChallenger
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.circuit_data import CircuitData, CommonCircuitData
from ..plonk.config import CircuitConfig
from ..plonk.vanishing import eval_vanishing_poly
from . import targets
from .targets import ProofWithPublicInputsTarget, VerifierCircuitTarget
from .fri_verifier import verify_fri_proof_circuit


@dataclasses.dataclass(frozen=True)
class _BatchT:
    point: object          # ExtTarget
    polynomials: tuple


@dataclasses.dataclass(frozen=True)
class _InstanceT:
    oracles: tuple
    batches: tuple


def get_fri_instance_target(builder, common: CommonCircuitData, zeta):
    g = ref.primitive_root_of_unity(common.degree_bits)
    zeta_next = builder.mul_const_extension(g, zeta)
    zeta_batch = _BatchT(point=zeta,
                         polynomials=tuple(common._fri_all_polys()))
    zeta_next_batch = _BatchT(
        point=zeta_next,
        polynomials=tuple(FriPolynomialInfo.from_range(
            2, common.zs_range.start, common.zs_range.stop)))
    return _InstanceT(oracles=tuple(common._fri_oracles()),
                      batches=(zeta_batch, zeta_next_batch))


def get_challenges_target(builder, pt: ProofWithPublicInputsTarget,
                          public_inputs_hash, circuit_digest,
                          common: CommonCircuitData) -> dict:
    proof = pt.proof
    nc = common.config.num_challenges
    ch = RecursiveChallenger(builder)
    ch.observe_hash(circuit_digest)
    ch.observe_hash(public_inputs_hash)
    ch.observe_cap(proof.wires_cap)
    plonk_betas = ch.get_n_challenges(nc)
    plonk_gammas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = ch.get_extension_challenge()

    for batch in proof.openings.to_fri_openings():
        ch.observe_extension_elements(batch)

    # FRI challenges (reference: fri/challenges.rs fri_challenges_target)
    fri_alpha = ch.get_extension_challenge()
    fri_betas = []
    for cap in proof.opening_proof.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    ch.observe_extension_elements(proof.opening_proof.final_poly)
    ch.observe_element(proof.opening_proof.pow_witness)
    fri_pow_response = ch.get_challenge()
    fri_query_indices = ch.get_n_challenges(
        common.config.fri_config.num_query_rounds)

    return {
        "plonk_betas": plonk_betas,
        "plonk_gammas": plonk_gammas,
        "plonk_alphas": plonk_alphas,
        "plonk_zeta": plonk_zeta,
        "fri_alpha": fri_alpha,
        "fri_betas": fri_betas,
        "fri_pow_response": fri_pow_response,
        "fri_query_indices": fri_query_indices,
    }


def verify_proof_circuit(builder, pt: ProofWithPublicInputsTarget,
                         inner_verifier_data: VerifierCircuitTarget,
                         common: CommonCircuitData) -> None:
    assert len(pt.public_inputs) == common.num_public_inputs
    public_inputs_hash = builder.public_inputs_hash_gadget(
        list(pt.public_inputs))
    challenges = get_challenges_target(
        builder, pt, public_inputs_hash, inner_verifier_data.circuit_digest,
        common)
    verify_proof_with_challenges_circuit(
        builder, pt.proof, public_inputs_hash, challenges,
        inner_verifier_data, common)


def verify_proof_with_challenges_circuit(builder, proof, public_inputs_hash,
                                         challenges,
                                         inner_verifier_data,
                                         common: CommonCircuitData) -> None:
    alg = TargetAlgebra(builder)
    o = proof.openings
    zeta = challenges["plonk_zeta"]
    one = builder.one_extension()

    # L_0(zeta) = (zeta^n - 1) / (n (zeta - 1))
    zeta_pow_deg = builder.exp_power_of_2_extension(zeta, common.degree_bits)
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    denom = builder.mul_const_extension(
        common.degree % ref.ORDER, builder.sub_extension(zeta, one))
    l_0_zeta = builder.div_extension(z_h_zeta, denom)

    lift = builder.convert_to_ext
    pi_hash_ext = [lift(h) for h in public_inputs_hash]
    vanishing_zeta = eval_vanishing_poly(
        alg, common, zeta,
        list(o.constants), list(o.wires), pi_hash_ext,
        list(o.plonk_zs), list(o.plonk_zs_next), list(o.partial_products),
        list(o.plonk_sigmas),
        [lift(b) for b in challenges["plonk_betas"]],
        [lift(g) for g in challenges["plonk_gammas"]],
        [lift(a) for a in challenges["plonk_alphas"]],
        l_0_zeta)

    qdf = common.quotient_degree_factor
    for i in range(common.config.num_challenges):
        chunk = o.quotient_polys[i * qdf:(i + 1) * qdf]
        scale = ReducingFactorTarget(zeta_pow_deg)
        recombined = scale.reduce(chunk, builder)
        computed = builder.mul_extension(z_h_zeta, recombined)
        builder.connect_extension(vanishing_zeta[i], computed)

    merkle_caps = [
        inner_verifier_data.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    instance = get_fri_instance_target(builder, common, zeta)
    verify_fri_proof_circuit(
        builder, instance, proof.openings.to_fri_openings(), challenges,
        merkle_caps, proof.opening_proof, common.fri_params)


def wrap_circuit(inner: CircuitData, register_inner: bool = False,
                 config: CircuitConfig | None = None):
    """The recursive verifier circuit of `inner`'s proofs, a step of the
    reference's bench_recursion chain (seed 1234 and, unless `config` is
    given, `standard_recursion_config()`, as `tests/golden_common.py`
    build_fib100_wrap). With `register_inner`, the wrap's public inputs are
    the inner proof's public inputs, then the inner verifier data's
    constants-and-sigmas cap, digest by digest, and its circuit digest, as
    an aggregation circuit exposes them; without, it has none, as in the
    reference. Returns (builder, witness): the builder holds the verifier,
    unbuilt (`build()` or `build_host()`), and `witness(proof)` is the
    PartialWitness of one wrap prove of `proof`."""
    config = config or CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config, seed=1234)
    pt = targets.add_virtual_proof_with_pis(builder, inner.common)
    vt = targets.add_virtual_verifier_data(builder,
                                           config.fri_config.cap_height)
    verify_proof_circuit(builder, pt, vt, inner.common)
    if register_inner:
        builder.register_public_inputs(pt.public_inputs)
        for digest in vt.constants_sigmas_cap:
            builder.register_public_inputs(digest)
        builder.register_public_inputs(vt.circuit_digest)

    def witness(proof) -> PartialWitness:
        pw = PartialWitness()
        targets.set_proof_with_pis_target(pw, pt, proof)
        targets.set_verifier_data_target(pw, vt, inner.verifier_only)
        return pw
    return builder, witness
