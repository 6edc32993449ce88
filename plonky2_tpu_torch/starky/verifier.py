"""STARK verifier — host-side (reference: starky/src/verifier.rs:29-210,
get_challenges.rs:26-80), including logUp lookup constraint checks
(verifier.rs:126-160)."""

from __future__ import annotations

import copy

from ..field import reference as ref
from ..fri.challenges import fri_challenges, observe_openings
from ..fri.verifier import verify_fri_proof
from ..gates.gate import EXT
from ..hash.hashers import PoseidonGoldilocksConfig
from ..iop.challenger import Challenger
from .config import StarkConfig
from .cross_table_lookup import (
    ctl_check_vars_single, eval_cross_table_lookup_checks, num_ctl_counts,
    verify_cross_table_lookups,
)
from .lookup import eval_lookups, get_grand_product_challenge_set
from .proof import StarkProofWithPublicInputs
from .stark import ConstraintConsumer, EvaluationFrame, Stark


def verify_stark_proof(stark: Stark,
                       proof_with_pis: StarkProofWithPublicInputs,
                       config: StarkConfig,
                       challenger: Challenger | None = None,
                       ctl_challenges=None, ctls=None,
                       table: int = 0, gc=None) -> None:
    """For CTL-linked tables pass the forked shared `challenger` (state after
    observing all trace caps + drawing CTL challenges), the challenges, the
    system CTL descriptors, and this table's index."""
    assert len(proof_with_pis.public_inputs) == stark.PUBLIC_INPUTS
    proof = proof_with_pis.proof
    public_inputs = [x % ref.ORDER for x in proof_with_pis.public_inputs]

    # recover degree from the FRI proof shape
    lde_bits = (config.fri_config.cap_height
                + len(proof.opening_proof.query_round_proofs[0]
                      .initial_trees_proof.evals_proofs[0][1]))
    degree_bits = lde_bits - config.fri_config.rate_bits
    degree = 1 << degree_bits

    gc = gc or PoseidonGoldilocksConfig
    # replay challenges (reference: starky get_challenges.rs:26-80)
    if challenger is None:
        ch = Challenger(gc.hasher)
        ch.observe_cap(proof.trace_cap)
    else:
        ch = challenger
    lookup_challenges = None
    if stark.uses_lookups():
        if ctl_challenges is not None:
            pairs = ctl_challenges
        else:
            pairs = get_grand_product_challenge_set(ch, config.num_challenges)
        lookup_challenges = [beta for beta, _gamma in pairs]
    if stark.uses_lookups() or stark.requires_ctls():
        assert proof.auxiliary_polys_cap is not None
        ch.observe_cap(proof.auxiliary_polys_cap)
    alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(proof.quotient_polys_cap)
    zeta = tuple(ch.get_extension_challenge())
    observe_openings(ch, proof.openings.to_fri_openings())
    fri_ch = fri_challenges(ch, proof.opening_proof, degree_bits,
                            config.fri_config)

    # constraint check at zeta
    g = ref.primitive_root_of_unity(degree_bits)
    zeta_pow_deg = ref.ext2_exp(zeta, degree)
    z_h_zeta = ref.ext2_sub(zeta_pow_deg, (1, 0))
    n_e = degree % ref.ORDER
    l_first = ref.ext2_mul(z_h_zeta, ref.ext2_inverse(
        ref.ext2_scalar_mul(ref.ext2_sub(zeta, (1, 0)), n_e)))
    gz = ref.ext2_scalar_mul(zeta, g)
    l_last = ref.ext2_mul(z_h_zeta, ref.ext2_inverse(
        ref.ext2_scalar_mul(ref.ext2_sub(gz, (1, 0)), n_e)))
    last = ref.inverse(g)
    z_last = ref.ext2_sub(zeta, (last, 0))

    local = [tuple(v) for v in proof.openings.local_values]
    next_vals = [tuple(v) for v in proof.openings.next_values]
    frame = EvaluationFrame(local, next_vals, [(p, 0) for p in public_inputs])
    consumer = ConstraintConsumer(EXT, [EXT.const(a) for a in alphas],
                                  z_last, l_first, l_last)
    stark.eval(EXT, frame, consumer)
    num_lk = stark.num_lookup_helper_columns(config)
    num_ctl_helpers = 0
    num_ctl_zs = 0
    if stark.uses_lookups():
        aux = [tuple(v) for v in proof.openings.auxiliary_polys][:num_lk]
        aux_next = [tuple(v)
                    for v in proof.openings.auxiliary_polys_next][:num_lk]
        eval_lookups(EXT, stark, stark.lookups(), local, next_vals,
                     aux, aux_next, [EXT.const(c) for c in lookup_challenges],
                     consumer)
    if stark.requires_ctls():
        assert ctls is not None and ctl_challenges is not None
        max_degree = max(2, stark.constraint_degree())
        per_ctl_helpers = num_ctl_counts(ctls, table, max_degree)
        aux_all = [tuple(v) for v in proof.openings.auxiliary_polys]
        aux_all_next = [tuple(v)
                        for v in proof.openings.auxiliary_polys_next]
        ctl_zs = list(zip(aux_all[num_lk:], aux_all_next[num_lk:]))
        num_ctl_zs = len(proof.openings.ctl_zs_first or [])
        num_ctl_helpers = len(ctl_zs) - num_ctl_zs
        chal_elts = [(EXT.const(b), EXT.const(g2))
                     for b, g2 in ctl_challenges]
        ctl_vars = ctl_check_vars_single(table, ctl_zs, ctls, chal_elts,
                                         per_ctl_helpers)
        eval_cross_table_lookup_checks(EXT, local, next_vals, ctl_vars,
                                       consumer, max_degree)
    vanishing = consumer.accs

    qdf = stark.quotient_degree_factor()
    for i in range(config.num_challenges):
        chunk = proof.openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = (0, 0)
        for c in reversed(chunk):
            acc = ref.ext2_add(ref.ext2_mul(acc, zeta_pow_deg), tuple(c))
        assert tuple(vanishing[i]) == tuple(ref.ext2_mul(z_h_zeta, acc)), \
            f"quotient mismatch for challenge {i}"

    caps = [proof.trace_cap]
    if proof.auxiliary_polys_cap is not None:
        caps.append(proof.auxiliary_polys_cap)
    caps.append(proof.quotient_polys_cap)
    verify_fri_proof(
        stark.fri_instance(zeta, g, config, num_ctl_helpers=num_ctl_helpers,
                           num_ctl_zs=num_ctl_zs),
        proof.openings.to_fri_openings(),
        fri_ch,
        caps,
        proof.opening_proof,
        config.fri_params(degree_bits),
        hasher=gc.hasher,
    )


def verify_multi(starks, multi_proof, config: StarkConfig, ctls,
                 gc=None) -> None:
    """Verify a CTL-linked multi-STARK system: replay the shared transcript
    (all trace caps, CTL challenge pairs), verify each table's proof from a
    fork, then check the cross-table grand sums
    (reference: verify_cross_table_lookups, cross_table_lookup.rs:946-995)."""
    gc = gc or PoseidonGoldilocksConfig
    proofs = multi_proof.stark_proofs
    ch = Challenger(gc.hasher)
    for p in proofs:
        ch.observe_cap(p.proof.trace_cap)
    ctl_challenges = get_grand_product_challenge_set(ch, config.num_challenges)
    assert ctl_challenges == multi_proof.ctl_challenges, \
        "CTL challenge transcript mismatch"
    for i, (stark, p) in enumerate(zip(starks, proofs)):
        verify_stark_proof(stark, p, config,
                           challenger=copy.deepcopy(ch),
                           ctl_challenges=ctl_challenges, ctls=ctls, table=i,
                           gc=gc)
    ctl_zs_first = [list(p.proof.openings.ctl_zs_first or [])
                    for p in proofs]
    verify_cross_table_lookups(ctls, ctl_zs_first, config.num_challenges)
