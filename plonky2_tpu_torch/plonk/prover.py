"""PLONK prover, five rounds (reference plonk/prover.rs:104-355).

Witness generation is the host fixpoint of `iop/generator.py`. Round 1
commits the wires, round 2 the permutation Z and partial products (an
exclusive product scan over the rows), round 3 the quotient (every
constraint over the whole LDE grid, then a coset iNTT), round 4 opens all
polynomials at zeta and g*zeta, round 5 is FRI. Every tensor lives on the
device of the circuit's committed constants; every commit and the FRI trees
hash with the config's hasher. Under a zero-knowledge config every commit
but the constants' is salted (`fri/oracle.py`) from the numpy Generator
`rng` (an unseeded one when None), drawn wires, then Z and the partial
products, then the quotient.

`prove_many` proves B witnesses of one circuit with a proof axis inside
every tensor of rounds 1-4 ([rows, B, n] and [rows, B, N]): each commit,
scan and gate evaluation is one call for the B proofs, and the challengers
and FRI run a proof at a time. `prove` is its B = 1, and
`batch_prover.prove_batch` its B > 1. The proofs equal B calls of `prove`
whenever the witness generators draw the same random values.

`timing`, a `utils/timing.TimingTree` (a default one when None, enabled by
PLONKY2_TPU_TIMING or PLONKY2_TPU_PROFILE), scopes the reference's timed!
phases under the JAX package's labels: SERIAL_SCOPES for `prove`,
`batch_prover.BATCH_SCOPES` for `prove_batch`, the last a proof's FRI. An
enabled tree ends each scope in a synchronize of the prover's device; a
disabled one adds none. The host work between those phases lies in the
port's own depth-0 scopes, HOST_SPANS, which end in no synchronize:
`witness upload` (the public inputs, their hash, and inside it `wire
matrix`: the wire matrix built from the set representatives, counted in
`wire_values`, and its upload), `challenges` (each Fiat-Shamir block, and
a proof's openings observed and its FRI instance) and `proof assembly`.
Inside round 3 the scopes are `coset values`, `gate constraints` (a `gate
<id>` scope for each gate with constraints), `permutation terms`, `alpha
reduction` and `quotient iNTT`; FRI's are in `fri/oracle.py` and
`fri/prover.py`. The tree counts the call's `proofs`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..fri.challenges import observe_openings
from ..fri.oracle import PolynomialBatch, commit_batch
from ..iop.challenger import Challenger
from ..iop.generator import generate_partial_witness
from ..iop.witness import wire_matrix
from ..ops import ntt
from ..ops.polynomial import eval_at_points, quotient_chunks, quotient_coset
from ..utils import timing as tracing
from ..utils.timing import TimingTree
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .vanishing import evaluate_gate_constraints_rows


# the scope labels of a serial prove, in order (JAX package: plonk/prover.py;
# reference: prover.rs's timed! phases); the last is each proof's FRI
SERIAL_SCOPES = ("run generators", "wires commitment",
                 "compute partial products", "zs+partial_products commitment",
                 "compute quotient polys", "quotient commitment",
                 "openings at zeta", "FRI opening proof")
# the port's depth-0 scopes of the host work between those (and between the
# STARK prover's)
HOST_SPANS = ("witness upload", "challenges", "proof assembly")


def prove(prover_data, common, inputs, timing: TimingTree | None = None,
          rng=None) -> ProofWithPublicInputs:
    """One proof; `rng`: the salts' numpy Generator of a zero-knowledge
    config."""
    return prove_many(prover_data, common, [inputs], timing, rng)[0]


def prove_many(prover_data, common, inputs_list,
               timing: TimingTree | None = None, rng=None,
               scopes: tuple = SERIAL_SCOPES
               ) -> list[ProofWithPublicInputs]:
    """B proofs of one circuit, one for each PartialWitness of
    `inputs_list`, their rounds 1-4 on a proof axis; `scopes`: the labels
    of the eight phases, the last formatted with the proof's index `b`."""
    timing = TimingTree() if timing is None else timing
    config = common.config
    fri_config = config.fri_config
    nc = config.num_challenges
    rate_bits, cap_height = fri_config.rate_bits, fri_config.cap_height
    device = prover_data.constants_sigmas_commitment.polynomials.device
    hasher = common.gc.hasher
    zk = config.zero_knowledge
    if zk and rng is None:
        rng = np.random.default_rng()

    def commit(coeffs):
        return commit_batch(coeffs, rate_bits, cap_height, hasher, zk, rng)

    def scope(i: int, b: int | None = None):
        return timing.scope(scopes[i].format(b=b), device, b)

    def host(i: int, b: int | None = None):
        return timing.scope(HOST_SPANS[i], b=b)

    timing.count("proofs", len(inputs_list))
    with scope(0):
        witnesses = [generate_partial_witness(inputs, prover_data, common)
                     for inputs in inputs_list]
    with host(0):
        public_inputs = [[w.get(t) for t in prover_data.public_inputs]
                         for w in witnesses]
        pi_hashes = [common.gc.hash_public_inputs(pis)
                     for pis in public_inputs]
        with timing.scope("wire matrix"):
            wires = _upload_wires(witnesses, device)    # [num_wires, B, n]
        del witnesses       # the fixpoint's tables, freed inside the span

    # round 1: wires
    with scope(1):
        wires_commitment = commit(ntt.ifft(wires))
    with host(1):
        challengers = []
        for pi_hash, cap in zip(pi_hashes, wires_commitment.caps()):
            challenger = Challenger(hasher)
            challenger.observe_hash(prover_data.circuit_digest)
            challenger.observe_hash(pi_hash)
            challenger.observe_cap(cap)
            challengers.append(challenger)
        betas, gammas = [], []
        for challenger in challengers:
            betas.append(challenger.get_n_challenges(nc))
            gammas.append(challenger.get_n_challenges(nc))

    # round 2: Z and partial products
    with scope(2):
        sigmas = gl.from_u64(prover_data.sigmas, device)
        subgroup = gl.from_u64(prover_data.subgroup, device)
        zs, pps = [], []
        for i in range(nc):
            z, pp = _partial_products(
                common, wires, sigmas, subgroup,
                _per_proof([b[i] for b in betas], device),
                _per_proof([g[i] for g in gammas], device))
            zs.append(z.unsqueeze(0))
            pps.append(pp)
        zs_pp = torch.cat(zs + pps)
    with scope(3):
        zs_pp_commitment = commit(ntt.ifft(zs_pp))
    with host(1):
        alphas = []
        for challenger, cap in zip(challengers, zs_pp_commitment.caps()):
            challenger.observe_cap(cap)
            alphas.append(challenger.get_n_challenges(nc))

    # round 3: quotient
    with scope(4):
        quotient_chunks = compute_quotient_polys(
            common, prover_data, pi_hashes, wires_commitment,
            zs_pp_commitment, betas, gammas, alphas)
    with scope(5):
        quotient_commitment = commit(quotient_chunks)

    # round 4: openings at zeta and g * zeta
    with host(1):
        g = ref.primitive_root_of_unity(common.degree_bits)
        zetas = []
        for challenger, cap in zip(challengers, quotient_commitment.caps()):
            challenger.observe_cap(cap)
            zeta = challenger.get_extension_challenge()
            assert ref.ext2_exp(zeta, common.degree) != (1, 0), \
                "Opening point is in the subgroup"
            zetas.append(zeta)
        zeta_nexts = [ref.ext2_scalar_mul(z, g) for z in zetas]
    cs = prover_data.constants_sigmas_commitment
    with scope(6):
        cs_e, w_e, zp_e, q_e = (
            eval_at_points(p, zetas)
            for p in (cs.polynomials, wires_commitment.coeffs,
                      zs_pp_commitment.coeffs, quotient_commitment.coeffs))
        zp_next = eval_at_points(zs_pp_commitment.coeffs, zeta_nexts)

    proofs = []
    for b, challenger in enumerate(challengers):
        with host(1, b):
            openings = OpeningSet(
                constants=[cs_e[b][j] for j in common.constants_range],
                plonk_sigmas=[cs_e[b][j] for j in common.sigmas_range],
                wires=w_e[b],
                plonk_zs=[zp_e[b][j] for j in common.zs_range],
                plonk_zs_next=[zp_next[b][j] for j in common.zs_range],
                partial_products=[zp_e[b][j]
                                  for j in common.partial_products_range],
                quotient_polys=q_e[b],
            )
            observe_openings(challenger, openings.to_fri_openings())
            oracles = [cs, wires_commitment.batches[b],
                       zs_pp_commitment.batches[b],
                       quotient_commitment.batches[b]]
            instance = common.get_fri_instance(zetas[b])

        # round 5: FRI
        with scope(7, b):
            opening_proof = PolynomialBatch.prove_openings(
                instance, oracles, challenger, common.fri_params)
        with host(2, b):
            proofs.append(ProofWithPublicInputs(
                proof=Proof(
                    wires_cap=oracles[1].merkle_tree.cap_digests(),
                    plonk_zs_partial_products_cap=oracles[2].merkle_tree
                    .cap_digests(),
                    quotient_polys_cap=oracles[3].merkle_tree.cap_digests(),
                    openings=openings,
                    opening_proof=opening_proof,
                ),
                public_inputs=public_inputs[b]))
    return proofs


def _upload_wires(witnesses, device) -> torch.Tensor:
    """The witnesses' wire matrix (`iop/witness.wire_matrix`) on `device`
    in one blocking copy, without `gl.from_u64`'s canonicalising pass: the
    witness holds canonical values. For a card the host matrix is pinned
    memory, which PyTorch's host allocator hands back to the next proof, so
    no proof pays to fault in fresh pages."""
    layout = witnesses[0].layout
    host = torch.empty((layout.num_wires, len(witnesses), layout.degree),
                       dtype=torch.int64,
                       pin_memory=torch.device(device).type == "cuda")
    wire_matrix(witnesses, out=host.numpy().view(np.uint64))
    tracing.count("host_reads")     # a blocking upload drains the queue
    return host.to(device)


def _per_proof(values: list, device) -> torch.Tensor:
    """One field element a proof -> [B, 1], broadcast over a proof's
    points."""
    return gl.from_u64(np.asarray(values, dtype=np.uint64),
                       device).unsqueeze(1)


def _permutation_factors(routed, s_id, sigmas, beta, gamma):
    """The permutation argument's numerators routed + beta k x + gamma and
    denominators routed + beta sigma + gamma, [nr, B, m] at m points x."""
    return (gl.add(gl.add(routed, gl.mul(s_id, beta)), gamma),
            gl.add(gl.add(routed, gl.mul(sigmas, beta)), gamma))


def _chunk_products(rows: torch.Tensor, size: int) -> torch.Tensor:
    """[nr, ...] -> [ceil(nr / size), ...]: product over each run of `size`
    rows, the last run ragged (reference: util/partial_products.rs)."""
    outs = []
    for lo in range(0, rows.shape[0], size):
        acc = rows[lo]
        for j in range(lo + 1, min(lo + size, rows.shape[0])):
            acc = gl.mul(acc, rows[j])
        outs.append(acc)
    return torch.stack(outs)


def _partial_products(common, wires, sigmas, subgroup, beta, gamma):
    """Z (exclusive running product of the row quotients) [B, n] and the
    partial products of each chunk, [num_partial_products, B, n], of wires
    [num_wires, B, n] under each proof's beta and gamma [B, 1]."""
    k = gl.from_u64(np.asarray(common.k_is, dtype=np.uint64),
                    wires.device).unsqueeze(1)
    s_id = gl.mul(k, subgroup).unsqueeze(1)               # [nr, 1, n]
    numer, denom = _permutation_factors(
        wires[:common.config.num_routed_wires], s_id, sigmas.unsqueeze(1),
        beta, gamma)
    cp = _chunk_products(gl.mul(numer, gl.inverse(denom)),
                         common.quotient_degree_factor)
    row_prod = cp[0]
    for j in range(1, cp.shape[0]):
        row_prod = gl.mul(row_prod, cp[j])
    z = gl.prod_scan_exclusive(row_prod)
    pps, acc = [], z
    for j in range(cp.shape[0] - 1):
        acc = gl.mul(acc, cp[j])
        pps.append(acc)
    return z, torch.stack(pps)


# grid points (proofs x LDE points) of one round-3 pass: a batch past it is
# evaluated in groups of proofs, which bounds the temporaries of the gate
# constraints and the permutation terms
ROUND3_POINTS = 1 << 21


def compute_quotient_polys(common, prover_data, pi_hashes, wires_commitment,
                           zs_pp_commitment, betas, gammas,
                           alphas) -> torch.Tensor:
    """[num_challenges * quotient_degree_factor, B, degree] coefficient
    chunks of each proof (reference: prover.rs:600-744); pi_hashes,
    betas, gammas and alphas hold one entry a proof, and the commitments
    are BatchCommitments."""
    qdf = common.quotient_degree_factor
    qdb = (qdf - 1).bit_length()
    rate_bits = common.config.fri_config.rate_bits
    assert qdb <= rate_bits, "constraint degree above rate unsupported"
    step = 1 << (rate_bits - qdb)
    N = common.degree << qdb
    B = len(pi_hashes)

    device = wires_commitment.coeffs.device
    with tracing.scope("coset values", device):
        cs_lde = prover_data.constants_sigmas_commitment.natural_lde(step)
        wires_lde = wires_commitment.natural_lde(step)      # [W, B, N]
        zs_pp_lde = zs_pp_commitment.natural_lde(step)

        x, zh_inv, (l_0_x,) = quotient_coset(common.degree_bits, qdb, (1,),
                                             device)
        k = gl.from_u64(np.asarray(common.k_is, dtype=np.uint64),
                        device).unsqueeze(1)
        consts = (zh_inv, l_0_x, gl.mul(k, x).unsqueeze(1))

    per = max(1, ROUND3_POINTS // N)
    values = torch.cat([
        _quotient_values(common, consts, cs_lde, wires_lde[:, lo:lo + per],
                         zs_pp_lde[:, lo:lo + per], pi_hashes[lo:lo + per],
                         betas[lo:lo + per], gammas[lo:lo + per],
                         alphas[lo:lo + per])
        for lo in range(0, B, per)], dim=1)                 # [nc, B, N]
    return quotient_chunks(values, qdf, common.degree)


def _quotient_values(common, consts, cs_lde, wires_lde, zs_pp_lde, pi_hashes,
                     betas, gammas, alphas) -> torch.Tensor:
    """The vanishing values over the grid divided by Z_H, [nc, B, N], of
    the B proofs of wires_lde [W, B, N] and zs_pp_lde [Z, B, N]."""
    zh_inv, l_0_x, s_id = consts
    qdb = (common.quotient_degree_factor - 1).bit_length()
    next_step = 1 << qdb
    nc = common.config.num_challenges
    nr = common.config.num_routed_wires
    qdf = common.quotient_degree_factor
    B, N = wires_lde.shape[1:]
    device = wires_lde.device

    def grid(rows):
        """[r, B, N] -> [r, B N], the B proofs' points side by side."""
        return rows.reshape(rows.shape[0], B * N)

    with tracing.scope("gate constraints", device):
        consts_rows = cs_lde[:common.num_constants].unsqueeze(1).expand(
            -1, B, -1)
        pi_rows = gl.from_u64(np.asarray(pi_hashes, dtype=np.uint64).T,
                              device).unsqueeze(-1).expand(-1, -1, N)
        constraint_rows = evaluate_gate_constraints_rows(
            common, grid(consts_rows), grid(wires_lde), grid(pi_rows)).view(
                -1, B, N)

    with tracing.scope("permutation terms", device):
        sigmas_rows = cs_lde[common.num_constants:].unsqueeze(1)
        next_zs_pp = torch.roll(zs_pp_lde, -next_step, dims=-1)
        routed = wires_lde[:nr]
        one = gl.const(1, device)
        pp_lo = common.partial_products_range.start
        num_prods = common.num_partial_products
        z1_terms, pp_terms = [], []
        for i in range(nc):
            beta = _per_proof([b[i] for b in betas], device)
            gamma = _per_proof([g[i] for g in gammas], device)
            z_x, z_gx = zs_pp_lde[i], next_zs_pp[i]
            z1_terms.append(gl.mul(l_0_x, gl.sub(z_x, one)))
            numer, denom = _permutation_factors(routed, s_id, sigmas_rows,
                                                beta, gamma)
            nprod = _chunk_products(numer, qdf)
            dprod = _chunk_products(denom, qdf)
            pps = zs_pp_lde[pp_lo + i * num_prods:pp_lo + (i + 1) * num_prods]
            accs = torch.cat([z_x.unsqueeze(0), pps, z_gx.unsqueeze(0)])
            pp_terms.append(gl.sub(gl.mul(accs[:-1], nprod),
                                   gl.mul(accs[1:], dprod)))
        terms = torch.cat([torch.stack(z1_terms)] + pp_terms
                          + [constraint_rows])

    with tracing.scope("alpha reduction", device):
        values = []
        for i in range(nc):
            apow = torch.stack([gl.powers(a[i], terms.shape[0], device)
                                for a in alphas], dim=1).unsqueeze(-1)
            values.append(gl.mul(gl.reduce_sum(gl.mul(terms, apow), 0),
                                 zh_inv))
        return torch.stack(values)
