"""FRI verifier — host python ints, polylog work
(plonky2_tpu/fri/verifier.py, on the port's Merkle verification).

Exact replica of the reference verification logic
(reference: plonky2/src/fri/verifier.rs — verify_fri_proof:62,
fri_combine_initial:123 with the okx sum*x tweak at :160-166,
compute_evaluation:22-47, fri_verifier_query_round:168-230).
"""

from __future__ import annotations

from ..field import reference as ref
from ..hash.merkle import verify_merkle_proof_oracle
from ..utils.bits import log2_strict, reverse_bits
from .config import FriParams
from .proof import FriProof
from .structure import FriChallenges, FriInstanceInfo, FriOpenings

E = tuple[int, int]  # extension element


def _reduce_rev(values, alpha: E) -> E:
    """ReducingFactor::reduce — Horner: sum_i alpha^i values[i]."""
    acc = (0, 0)
    for v in reversed(list(values)):
        acc = ref.ext2_add(ref.ext2_mul(acc, alpha), v)
    return acc


def fri_verify_proof_of_work(pow_response: int, pow_bits: int) -> None:
    assert pow_response < (1 << (64 - pow_bits)), "Invalid proof of work"


def verify_fri_proof(instance: FriInstanceInfo, openings: FriOpenings,
                     challenges: FriChallenges, initial_merkle_caps,
                     proof: FriProof, params: FriParams,
                     hasher) -> None:
    n = params.lde_size
    fri_verify_proof_of_work(challenges.fri_pow_response,
                             params.config.proof_of_work_bits)
    assert params.config.num_query_rounds == len(proof.query_round_proofs)

    reduced_openings = [
        _reduce_rev(batch.values, challenges.fri_alpha)
        for batch in openings.batches
    ]

    for x_index, round_proof in zip(challenges.fri_query_indices,
                                    proof.query_round_proofs):
        _verify_query_round(instance, challenges, reduced_openings,
                            initial_merkle_caps, proof, x_index, n,
                            round_proof, params, hasher)


def fri_combine_initial(instance: FriInstanceInfo, initial_proof,
                        alpha: E, subgroup_x: int,
                        reduced_openings, params: FriParams) -> E:
    total = (0, 0)
    for batch, reduced in zip(instance.batches, reduced_openings):
        evals = []
        for p in batch.polynomials:
            salted = (params.hiding
                      and instance.oracles[p.oracle_index].blinding)
            evals.append((initial_proof.unsalted_eval(
                p.oracle_index, p.polynomial_index, salted), 0))
        reduced_evals = _reduce_rev(evals, alpha)
        numerator = ref.ext2_sub(reduced_evals, reduced)
        denominator = ref.ext2_sub((subgroup_x, 0), batch.point)
        total = ref.ext2_mul(total,
                             ref.ext2_exp(alpha, len(batch.polynomials)))
        total = ref.ext2_add(total,
                             ref.ext2_mul(numerator,
                                          ref.ext2_inverse(denominator)))
    # okx circom tweak: the prover multiplied the final poly by X
    return ref.ext2_mul(total, (subgroup_x, 0))


def compute_evaluation(x: int, x_index_within_coset: int, arity_bits: int,
                       evals: list[E], beta: E) -> E:
    """Interpolate {(x*g^i, P(x*g^i))} and evaluate at beta
    (reference: verifier.rs:22-47)."""
    arity = 1 << arity_bits
    g = ref.primitive_root_of_unity(arity_bits)
    # reorder evals by bit-reversed index
    evs = [evals[reverse_bits(i, arity_bits)] for i in range(arity)]
    rev_idx = reverse_bits(x_index_within_coset, arity_bits)
    coset_start = ref.mul(x, ref.exp(g, arity - rev_idx))
    xs = []
    y = coset_start
    for _ in range(arity):
        xs.append(y)
        y = ref.mul(y, g)
    # Lagrange interpolation evaluated at beta (exact arithmetic, same result
    # as the reference's barycentric form)
    result = (0, 0)
    for i in range(arity):
        num = (1, 0)
        den = 1
        for j in range(arity):
            if j == i:
                continue
            num = ref.ext2_mul(num, ref.ext2_sub(beta, (xs[j], 0)))
            den = ref.mul(den, ref.sub(xs[i], xs[j]))
        term = ref.ext2_scalar_mul(ref.ext2_mul(num, evs[i]),
                                   ref.inverse(den))
        result = ref.ext2_add(result, term)
    return result


def _verify_query_round(instance, challenges, reduced_openings,
                        initial_merkle_caps, proof, x_index, n,
                        round_proof, params: FriParams, hasher) -> None:
    # initial tree proofs
    for (evals, merkle_proof), cap in zip(
            round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps):
        ok = verify_merkle_proof_oracle(
            [int(v) for v in evals], x_index, list(cap),
            list(merkle_proof), hasher)
        assert ok, "initial Merkle proof failed"

    log_n = log2_strict(n)
    subgroup_x = ref.mul(
        ref.MULTIPLICATIVE_GROUP_GENERATOR,
        ref.exp(ref.primitive_root_of_unity(log_n),
                reverse_bits(x_index, log_n)))

    old_eval = fri_combine_initial(
        instance, round_proof.initial_trees_proof, challenges.fri_alpha,
        subgroup_x, reduced_openings, params)

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = round_proof.steps[i].evals
        coset_index = x_index >> arity_bits
        x_index_within_coset = x_index & (arity - 1)
        assert tuple(evals[x_index_within_coset]) == tuple(old_eval), \
            f"fold consistency failed at layer {i}"
        old_eval = compute_evaluation(
            subgroup_x, x_index_within_coset, arity_bits, evals,
            challenges.fri_betas[i])
        flat = [c for e in evals for c in e]
        ok = verify_merkle_proof_oracle(
            flat, coset_index, list(proof.commit_phase_merkle_caps[i]),
            list(round_proof.steps[i].merkle_proof), hasher)
        assert ok, f"commit-phase Merkle proof failed at layer {i}"

        subgroup_x = ref.exp(subgroup_x, arity)
        x_index = coset_index

    # final polynomial check
    want = _eval_ext_poly(proof.final_poly, (subgroup_x, 0))
    assert tuple(want) == tuple(old_eval), \
        "final polynomial evaluation invalid"


def _eval_ext_poly(coeffs: list[E], x: E) -> E:
    acc = (0, 0)
    for c in reversed(coeffs):
        acc = ref.ext2_add(ref.ext2_mul(acc, x), c)
    return acc
