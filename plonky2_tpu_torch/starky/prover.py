"""STARK prover (reference: starky/src/prover.rs:37-260,
compute_quotient_polys:343-470) with logUp lookups (prover.rs:127-196) and
cross-table lookups (CTL aux columns batched into the same oracle,
prover.rs:165-196; multi-table orchestration mirrors what zk_evm builds on
get_ctl_data, cross_table_lookup.rs:226-252).

The commitments are the PLONK prover's (`PolynomialBatch`: K1's LDE, then
K3/K7 leaves and the K2/K6 tree under a device hasher); the quotient is one
algebra-generic `Stark.eval` over int64 field tensors on the whole natural
LDE coset, then K1's coset iNTT; the FRI proof is `prove_openings` (its PoW
wave on K2/K6). Lookup and CTL helper columns are field ops over the whole
trace (Fermat inverses, exact sum scans).

`timing` scopes the JAX package's phases, and the host work between them
under the PLONK prover's HOST_SPANS (`challenges`, `proof assembly`); round
3's scopes are `coset values`, `evaluate constraints` and `quotient iNTT`.
The tree counts the call's `proofs`.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..fri.challenges import observe_openings
from ..fri.oracle import PolynomialBatch
from ..gates.gate import GFAlgebra
from ..hash.hashers import PoseidonGoldilocksConfig
from ..iop.challenger import Challenger
from ..ops.polynomial import eval_at_points, quotient_chunks, quotient_coset
from ..plonk.prover import HOST_SPANS
from ..utils import timing as tracing
from ..utils.bits import log2_strict
from ..utils.timing import TimingTree
from .config import StarkConfig
from .cross_table_lookup import (
    ctl_check_vars_single, eval_cross_table_lookup_checks, get_ctl_data,
    num_ctl_counts,
)
from .lookup import (
    eval_lookups, get_grand_product_challenge_set, lookup_helper_columns,
)
from .proof import (
    MultiProof, StarkOpeningSet, StarkProof, StarkProofWithPublicInputs,
)
from .stark import ConstraintConsumer, EvaluationFrame, Stark


def _device(device) -> torch.device:
    """The prover's device: `cuda` unless the caller names another; no
    fallback when there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("STARK prove on cuda: no CUDA device (pass "
                           "device='cpu' to prove on the CPU)")
    return device


def _on(trace, device) -> torch.Tensor:
    """A uint64 numpy trace (or a field tensor) as a tensor on `device`."""
    if isinstance(trace, torch.Tensor):
        if trace.device.type != device.type:
            tracing.count("host_reads")     # a copy between host and card
        return trace.to(device)
    return gl.from_u64(np.asarray(trace, dtype=np.uint64), device)


def prove(stark: Stark, config: StarkConfig, trace,
          public_inputs: list[int],
          timing: TimingTree | None = None,
          challenger: Challenger | None = None,
          ctl_data=None, ctl_challenges=None, ctls=None,
          table: int = 0, gc=None, device=None) -> StarkProofWithPublicInputs:
    """trace: uint64 [COLUMNS, degree] of trace values (column-major rows).

    For CTL-linked tables, pass the shared post-CTL-challenge `challenger`
    plus this table's `ctl_data` and the system-wide `ctl_challenges`/`ctls`.
    `gc` selects the hashing configuration (default Poseidon — the
    reference's starky is likewise generic over C). Runs on `device`,
    `cuda` unless given.
    """
    gc = gc or PoseidonGoldilocksConfig
    timing = timing or TimingTree()
    device = _device(device)
    assert trace.shape[0] == stark.COLUMNS
    degree = trace.shape[1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    assert fri_params.total_arities <= degree_bits + rate_bits - cap_height
    assert stark.constraint_degree() <= (1 << rate_bits) + 1, \
        "constraint degree must be <= blowup + 1"

    _, challenges, assembly = HOST_SPANS
    timing.count("proofs")
    with timing.scope("trace to device", device):
        trace_t = _on(trace, device)
    with timing.scope("compute trace commitment", device):
        trace_commitment = PolynomialBatch.from_values(
            trace_t, rate_bits, cap_height, gc.hasher)

    if challenger is None:
        with timing.scope(challenges):
            challenger = Challenger(gc.hasher)
            challenger.observe_cap(trace_commitment.merkle_tree.cap_digests())

    # logUp lookups: draw (beta, gamma) challenge pairs, use the betas; with
    # CTLs the shared ctl challenges are reused (reference: prover.rs:131-141)
    lookup_challenges = None
    aux_commitment = None
    aux_polys = None
    num_lookup_columns = 0
    num_ctl_helpers = 0
    num_ctl_zs = 0
    if stark.uses_lookups():
        if ctl_challenges is not None:
            pairs = ctl_challenges
        else:
            with timing.scope(challenges):
                pairs = get_grand_product_challenge_set(
                    challenger, config.num_challenges)
        lookup_challenges = [beta for beta, _gamma in pairs]
        with timing.scope("compute lookup helper columns", device):
            aux_polys = torch.cat([
                lookup_helper_columns(lookup, trace_t, beta,
                                      stark.constraint_degree())
                for lookup in stark.lookups() for beta in lookup_challenges])
        num_lookup_columns = aux_polys.shape[0]

    if ctl_data is not None and ctl_data.zs_columns:
        assert stark.requires_ctls(), \
            "stark participating in CTLs must override requires_ctls()"
        ctl_aux = ctl_data.auxiliary_polys()
        num_ctl_zs = len(ctl_data.zs_columns)
        num_ctl_helpers = ctl_aux.shape[0] - num_ctl_zs
        aux_polys = (ctl_aux if aux_polys is None
                     else torch.cat([aux_polys, ctl_aux]))

    if aux_polys is not None:
        with timing.scope("compute auxiliary polynomials commitment", device):
            aux_commitment = PolynomialBatch.from_values(
                aux_polys, rate_bits, cap_height, gc.hasher)

    with timing.scope(challenges):
        if aux_commitment is not None:
            challenger.observe_cap(aux_commitment.merkle_tree.cap_digests())
        alphas = challenger.get_n_challenges(config.num_challenges)

    with timing.scope("compute quotient polys", device):
        quotient_chunks = compute_quotient_polys(
            stark, config, trace_commitment, aux_commitment,
            lookup_challenges, ctl_challenges, ctls, table, public_inputs,
            alphas, degree_bits)
    with timing.scope("compute quotient commitment", device):
        quotient_commitment = PolynomialBatch.from_coeffs(
            quotient_chunks, rate_bits, cap_height, gc.hasher)

    with timing.scope(challenges):
        challenger.observe_cap(quotient_commitment.merkle_tree.cap_digests())
        zeta = challenger.get_extension_challenge()
        g = ref.primitive_root_of_unity(degree_bits)
        assert ref.ext2_exp(zeta, degree) != (1, 0), \
            "Opening point is in the subgroup"
        zeta_next = ref.ext2_scalar_mul(zeta, g)

    requires_ctl = ctl_data is not None and ctl_data.zs_columns
    with timing.scope("openings", device):
        ctl_zs_first = None
        if requires_ctl:
            zs = aux_commitment.polynomials[
                num_lookup_columns + num_ctl_helpers:]
            ctl_zs_first = [v[0] for v in eval_at_points(zs, [(1, 0)])[0]]
        trace_p = trace_commitment.polynomials
        aux = aux_commitment.polynomials if aux_commitment else None
        openings = StarkOpeningSet(
            local_values=eval_at_points(trace_p, [zeta])[0],
            next_values=eval_at_points(trace_p, [zeta_next])[0],
            quotient_polys=eval_at_points(quotient_commitment.polynomials,
                                          [zeta])[0],
            auxiliary_polys=(eval_at_points(aux, [zeta])[0]
                             if aux is not None else None),
            auxiliary_polys_next=(eval_at_points(aux, [zeta_next])[0]
                                  if aux is not None else None),
            ctl_zs_first=ctl_zs_first,
        )

    with timing.scope(challenges):
        observe_openings(challenger, openings.to_fri_openings())
        instance = stark.fri_instance(zeta, g, config,
                                      num_ctl_helpers=num_ctl_helpers,
                                      num_ctl_zs=num_ctl_zs)
        commitments = [trace_commitment]
        if aux_commitment is not None:
            commitments.append(aux_commitment)
        commitments.append(quotient_commitment)
    with timing.scope("FRI opening proof", device):
        opening_proof = PolynomialBatch.prove_openings(
            instance, commitments, challenger, fri_params)

    with timing.scope(assembly):
        return StarkProofWithPublicInputs(
            proof=StarkProof(
                trace_cap=trace_commitment.merkle_tree.cap_digests(),
                quotient_polys_cap=quotient_commitment.merkle_tree
                .cap_digests(),
                openings=openings,
                opening_proof=opening_proof,
                auxiliary_polys_cap=(aux_commitment.merkle_tree.cap_digests()
                                     if aux_commitment else None),
            ),
            public_inputs=list(public_inputs))


def prove_multi(starks: list[Stark], config: StarkConfig,
                traces: list, ctls, public_inputs: list[list[int]],
                timing: TimingTree | None = None, gc=None,
                device=None) -> MultiProof:
    """Prove a CTL-linked multi-STARK system: one shared challenger observes
    every trace cap, draws the CTL challenges, computes all tables' CTL aux
    columns, then each table is proven from a fork of that transcript state
    (reference flow: get_ctl_data, cross_table_lookup.rs:226-252)."""
    gc = gc or PoseidonGoldilocksConfig
    timing = timing or TimingTree()
    device = _device(device)
    max_degree = max(s.constraint_degree() for s in starks)
    assert max_degree >= 2, "CTL helper chunks need constraint degree >= 2"
    with timing.scope("traces to device", device):
        trace_ts = [_on(t, device) for t in traces]
    challenger = Challenger(gc.hasher)
    with timing.scope("trace commitments", device):
        commitments = [PolynomialBatch.from_values(
            t, config.fri_config.rate_bits, config.fri_config.cap_height,
            gc.hasher) for t in trace_ts]
    for c in commitments:
        challenger.observe_cap(c.merkle_tree.cap_digests())
    with timing.scope("ctl data", device):
        ctl_challenges, ctl_data_per_table = get_ctl_data(
            config, trace_ts, ctls, challenger, max_degree)
    proofs = []
    for i, (stark, trace) in enumerate(zip(starks, trace_ts)):
        proofs.append(prove(
            stark, config, trace, public_inputs[i], timing,
            challenger=copy.deepcopy(challenger),
            ctl_data=ctl_data_per_table[i], ctl_challenges=ctl_challenges,
            ctls=ctls, table=i, gc=gc, device=device))
    return MultiProof(stark_proofs=proofs, ctl_challenges=ctl_challenges)


def compute_quotient_polys(stark, config, trace_commitment, aux_commitment,
                           lookup_challenges, ctl_challenges, ctls, table,
                           public_inputs, alphas,
                           degree_bits: int) -> torch.Tensor:
    """[num_challenges * quotient_degree_factor, degree] coefficient chunks:
    every constraint over the natural LDE coset of 2^qdb points a row, times
    Z_H^-1, then the coset iNTT (reference: prover.rs:343-470)."""
    qdf = stark.quotient_degree_factor()
    qdb = (qdf - 1).bit_length()
    rate_bits = config.fri_config.rate_bits
    assert qdb <= rate_bits
    step = 1 << (rate_bits - qdb)
    next_step = 1 << qdb
    N = 1 << (degree_bits + qdb)
    last = ref.inverse(ref.primitive_root_of_unity(degree_bits))  # g^{n-1}

    device = trace_commitment.polynomials.device
    with tracing.scope("coset values", device):
        trace_lde = trace_commitment.natural_lde(step)   # [cols, N]

        x, zh_inv, (l_first, l_last) = quotient_coset(
            degree_bits, qdb, (1, last), device)
        z_last = gl.sub(x, gl.const(last, device))
        del x

    with tracing.scope("evaluate constraints", device):
        alg = GFAlgebra((N,), device)

        def rows(t):
            return list(t), list(torch.roll(t, -next_step, dims=-1))

        local, next_ = rows(trace_lde)
        pis = [alg.const(p) for p in public_inputs]
        frame = EvaluationFrame(local, next_, pis)
        consumer = ConstraintConsumer(alg, [alg.const(a) for a in alphas],
                                      z_last, l_first, l_last)
        stark.eval(alg, frame, consumer)
        num_lk = 0
        if aux_commitment is not None:
            aux_local, aux_next = rows(aux_commitment.natural_lde(step))
        if stark.uses_lookups():
            num_lk = stark.num_lookup_helper_columns(config)
            eval_lookups(alg, stark, stark.lookups(), local, next_,
                         aux_local, aux_next,
                         [alg.const(c) for c in lookup_challenges], consumer)
        if ctls is not None:
            max_degree = max(2, stark.constraint_degree())
            ctl_chals = [(alg.const(b), alg.const(c))
                         for b, c in ctl_challenges]
            ctl_zs = list(zip(aux_local[num_lk:], aux_next[num_lk:]))
            ctl_vars = ctl_check_vars_single(
                table, ctl_zs, ctls, ctl_chals,
                num_ctl_counts(ctls, table, max_degree))
            eval_cross_table_lookup_checks(alg, local, next_, ctl_vars,
                                           consumer, max_degree)
        quotient_values = torch.stack([gl.mul(acc, zh_inv)
                                       for acc in consumer.accs])  # [nc, N]

    return quotient_chunks(quotient_values, qdf, 1 << degree_bits)
