"""In-circuit FRI verifier (reference: plonky2/src/fri/recursive_verifier.rs).

Structure mirrors the native fri/verifier.py: PoW check, precomputed reduced
openings, then per query round: initial Merkle proofs, combine-initial with
the okx final-poly-times-X tweak, arity folds via coset-interpolation gates,
final polynomial evaluation.
"""

from __future__ import annotations

from ..field import reference as ref
from ..fri.config import FriParams
from ..gadgets.misc import ReducingFactorTarget
from ..utils.bits import reverse_index_bits_perm


def verify_fri_proof_circuit(builder, instance, openings_batches, challenges,
                             initial_merkle_caps, proof, params: FriParams):
    """instance: FriInstanceInfo with ExtTarget points; openings_batches:
    list of lists of ExtTarget; challenges: dict with fri_alpha (ExtTarget),
    fri_betas, fri_pow_response, fri_query_indices (Targets)."""
    n = params.lde_size
    n_log = params.lde_bits

    builder.assert_leading_zeros(challenges["fri_pow_response"],
                                 params.config.proof_of_work_bits)

    # precompute reduced openings: sum_i alpha^i batch[i]
    alpha0 = challenges["fri_alpha"]
    reduced_openings = []
    for batch_values in openings_batches:
        rf = ReducingFactorTarget(alpha0)
        reduced_openings.append(rf.reduce(batch_values, builder))

    for qi, round_proof in enumerate(proof.query_round_proofs):
        _verify_query_round(builder, instance, challenges, reduced_openings,
                            initial_merkle_caps, proof,
                            challenges["fri_query_indices"][qi], n_log,
                            round_proof, params)


def _verify_query_round(builder, instance, challenges, reduced_openings,
                        initial_merkle_caps, proof, x_index, n_log,
                        round_proof, params: FriParams):
    cap_height = params.config.cap_height
    x_index_bits = builder.low_bits(x_index, n_log, 64)
    cap_index = builder.le_sum(x_index_bits[len(x_index_bits) - cap_height:])

    # initial Merkle proofs
    for (evals, sibs), cap in zip(round_proof.initial_trees_proof.evals_proofs,
                                  initial_merkle_caps):
        builder.verify_merkle_proof_to_cap_with_cap_index(
            evals, x_index_bits, cap_index, cap, sibs)

    # subgroup_x = coset_shift * phi^rev(x_index)
    phi = ref.primitive_root_of_unity(n_log)
    subgroup_x = builder.mul(
        builder.constant(ref.MULTIPLICATIVE_GROUP_GENERATOR),
        builder.exp_from_bits_const_base(phi, list(reversed(x_index_bits))))

    old_eval = _combine_initial(builder, instance,
                                round_proof.initial_trees_proof,
                                challenges["fri_alpha"], subgroup_x,
                                reduced_openings, params)

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        within_bits = x_index_bits[:arity_bits]
        within = builder.le_sum(within_bits)

        new_eval = builder.random_access_extension(within, list(evals))
        builder.connect_extension(new_eval, old_eval)

        old_eval = _compute_evaluation(builder, subgroup_x, within_bits,
                                       arity_bits, evals,
                                       challenges["fri_betas"][i])

        flat = [c for e in evals for c in e]
        builder.verify_merkle_proof_to_cap_with_cap_index(
            flat, coset_index_bits, cap_index,
            proof.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof)

        subgroup_x = builder.exp_power_of_2_base(subgroup_x, arity_bits)
        x_index_bits = coset_index_bits

    # final polynomial evaluation: Horner over subgroup_x
    point = ReducingFactorTarget(builder.convert_to_ext(subgroup_x))
    eval_ = point.reduce(list(proof.final_poly), builder)
    builder.connect_extension(eval_, old_eval)


def _combine_initial(builder, instance, initial_proof, alpha, subgroup_x,
                     reduced_openings, params: FriParams):
    subgroup_x_ext = builder.convert_to_ext(subgroup_x)
    rf = ReducingFactorTarget(alpha)
    total = builder.zero_extension()
    for batch, reduced in zip(instance.batches, reduced_openings):
        evals = []
        for p in batch.polynomials:
            salted = params.hiding and instance.oracles[p.oracle_index].blinding
            evals.append(initial_proof.unsalted_eval(
                p.oracle_index, p.polynomial_index, salted))
        reduced_evals = rf.reduce_base(evals, builder)
        numerator = builder.sub_extension(reduced_evals, reduced)
        denominator = builder.sub_extension(subgroup_x_ext, batch.point)
        total = rf.shift(total, builder)
        total = builder.div_add_extension(numerator, denominator, total)
    # okx circom tweak: prover multiplied the final poly by X
    return builder.mul_extension(total, subgroup_x_ext)


def _compute_evaluation(builder, x, within_bits, arity_bits, evals, beta):
    """Infer P(beta) from the arity-coset evaluations
    (reference: fri/recursive_verifier.rs:30-77)."""
    arity = 1 << arity_bits
    assert len(evals) == arity
    g = ref.primitive_root_of_unity(arity_bits)
    g_inv = ref.exp(g, arity - 1)
    perm = reverse_index_bits_perm(arity)
    evs = [evals[perm[i]] for i in range(arity)]
    start = builder.exp_from_bits_const_base(g_inv,
                                             list(reversed(within_bits)))
    coset_start = builder.mul(start, x)
    return builder.interpolate_coset(arity_bits, coset_start, evs, beta)
