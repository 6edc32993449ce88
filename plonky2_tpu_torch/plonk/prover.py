"""PLONK prover, five rounds (reference plonk/prover.rs:104-355).

Witness generation is the host fixpoint of `iop/generator.py`. Round 1
commits the wires, round 2 the permutation Z and partial products (an
exclusive product scan over the rows), round 3 the quotient (every
constraint over the whole LDE grid, then a coset iNTT), round 4 opens all
polynomials at zeta and g*zeta, round 5 is FRI. Every tensor lives on the
device of the circuit's committed constants; every commit and the FRI trees
hash with the config's hasher.

`prove(..., step=...)` lets a caller time or profile two steps of a prove:
`step(name)` returns a context manager, entered around the host witness
fixpoint ("witness fixpoint") and round 3 ("round 3").
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..field.extension import GF2, gf2_powers
from ..fri.challenges import observe_openings
from ..fri.oracle import PolynomialBatch
from ..iop.challenger import Challenger
from ..iop.generator import generate_partial_witness
from ..ops import ntt
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .vanishing import evaluate_gate_constraints_rows


def prove(prover_data, common, inputs, step=None) -> ProofWithPublicInputs:
    step = step or (lambda name: contextlib.nullcontext())
    config = common.config
    fri_config = config.fri_config
    nc = config.num_challenges
    rate_bits, cap_height = fri_config.rate_bits, fri_config.cap_height
    device = prover_data.constants_sigmas_commitment.polynomials.device
    hasher = common.gc.hasher

    with step("witness fixpoint"):
        witness = generate_partial_witness(inputs, prover_data, common)
    public_inputs = [witness.get(t) for t in prover_data.public_inputs]
    public_inputs_hash = common.gc.hash_public_inputs(public_inputs)
    wires = gl.from_u64(witness.full_witness(), device)     # [num_wires, n]

    # round 1: wires
    wires_commitment = PolynomialBatch.from_values(wires, rate_bits,
                                                   cap_height, hasher)
    challenger = Challenger(hasher)
    challenger.observe_hash(prover_data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_commitment.merkle_tree.cap_digests())
    betas = challenger.get_n_challenges(nc)
    gammas = challenger.get_n_challenges(nc)

    # round 2: Z and partial products
    sigmas = gl.from_u64(prover_data.sigmas, device)
    subgroup = gl.from_u64(prover_data.subgroup, device)
    zs, pps = [], []
    for i in range(nc):
        z, pp = _partial_products(common, wires, sigmas, subgroup, betas[i],
                                  gammas[i])
        zs.append(z.unsqueeze(0))
        pps.append(pp)
    zs_pp_commitment = PolynomialBatch.from_values(torch.cat(zs + pps),
                                                   rate_bits, cap_height,
                                                   hasher)
    challenger.observe_cap(zs_pp_commitment.merkle_tree.cap_digests())
    alphas = challenger.get_n_challenges(nc)

    # round 3: quotient
    with step("round 3"):
        quotient_chunks = compute_quotient_polys(
            common, prover_data, public_inputs_hash, wires_commitment,
            zs_pp_commitment, betas, gammas, alphas)
    quotient_commitment = PolynomialBatch.from_coeffs(quotient_chunks,
                                                      rate_bits, cap_height,
                                                      hasher)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap_digests())

    # round 4: openings at zeta and g * zeta
    zeta = challenger.get_extension_challenge()
    assert ref.ext2_exp(zeta, common.degree) != (1, 0), \
        "Opening point is in the subgroup"
    zeta_next = ref.ext2_scalar_mul(
        zeta, ref.primitive_root_of_unity(common.degree_bits))
    cs = prover_data.constants_sigmas_commitment.polynomials
    zs_pp = zs_pp_commitment.polynomials
    cs_e, w_e, zp_e, q_e = (
        _eval_at(p, zeta) for p in (cs, wires_commitment.polynomials, zs_pp,
                                    quotient_commitment.polynomials))
    zp_next = _eval_at(zs_pp, zeta_next)
    openings = OpeningSet(
        constants=[cs_e[j] for j in common.constants_range],
        plonk_sigmas=[cs_e[j] for j in common.sigmas_range],
        wires=w_e,
        plonk_zs=[zp_e[j] for j in common.zs_range],
        plonk_zs_next=[zp_next[j] for j in common.zs_range],
        partial_products=[zp_e[j] for j in common.partial_products_range],
        quotient_polys=q_e,
    )
    observe_openings(challenger, openings.to_fri_openings())

    # round 5: FRI
    oracles = [prover_data.constants_sigmas_commitment, wires_commitment,
               zs_pp_commitment, quotient_commitment]
    opening_proof = PolynomialBatch.prove_openings(
        common.get_fri_instance(zeta), oracles, challenger, common.fri_params)

    proof = Proof(
        wires_cap=wires_commitment.merkle_tree.cap_digests(),
        plonk_zs_partial_products_cap=zs_pp_commitment.merkle_tree
        .cap_digests(),
        quotient_polys_cap=quotient_commitment.merkle_tree.cap_digests(),
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof=proof, public_inputs=public_inputs)


# elements of the coefficient block `_eval_at` multiplies at once: wider
# blocks (a STARK trace of 128 columns over 2^20 rows) go in runs of rows
EVAL_CHUNK = 1 << 24


def _eval_at(coeffs: torch.Tensor, z) -> list:
    """Every row of coeffs [num, n] evaluated at the extension point z."""
    n = coeffs.shape[-1]
    zp = gf2_powers(z, n, coeffs.device)
    rows = max(1, EVAL_CHUNK // n)
    out = []
    for lo in range(0, coeffs.shape[0], rows):
        c = coeffs[lo:lo + rows]
        out += GF2(gl.reduce_sum(gl.mul(c, zp.c0), -1),
                   gl.reduce_sum(gl.mul(c, zp.c1), -1)).to_pairs()
    return out


def _chunk_products(rows: torch.Tensor, size: int) -> torch.Tensor:
    """[nr, N] -> [ceil(nr / size), N]: product over each run of `size`
    rows, the last run ragged (reference: util/partial_products.rs)."""
    outs = []
    for lo in range(0, rows.shape[0], size):
        acc = rows[lo]
        for j in range(lo + 1, min(lo + size, rows.shape[0])):
            acc = gl.mul(acc, rows[j])
        outs.append(acc)
    return torch.stack(outs)


def _partial_products(common, wires, sigmas, subgroup, beta: int,
                      gamma: int):
    """Z (exclusive running product of the row quotients) and the partial
    products of each chunk, [num_partial_products, n]."""
    nr = common.config.num_routed_wires
    routed = wires[:nr]
    k = gl.from_u64(np.asarray(common.k_is, dtype=np.uint64),
                    wires.device).unsqueeze(1)
    numer = gl.add_const(gl.add(routed, gl.mul_const(gl.mul(k, subgroup),
                                                     beta)), gamma)
    denom = gl.add_const(gl.add(routed, gl.mul_const(sigmas, beta)), gamma)
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


def compute_quotient_polys(common, prover_data, public_inputs_hash,
                           wires_commitment, zs_pp_commitment, betas, gammas,
                           alphas) -> torch.Tensor:
    """[num_challenges * quotient_degree_factor, degree] coefficient chunks
    (reference: prover.rs:600-744)."""
    qdf = common.quotient_degree_factor
    qdb = (qdf - 1).bit_length()
    rate_bits = common.config.fri_config.rate_bits
    assert qdb <= rate_bits, "constraint degree above rate unsupported"
    step = 1 << (rate_bits - qdb)
    next_step = 1 << qdb
    degree = common.degree
    N = degree << qdb
    nc = common.config.num_challenges
    nr = common.config.num_routed_wires
    g_shift = ref.MULTIPLICATIVE_GROUP_GENERATOR

    cs_lde = prover_data.constants_sigmas_commitment.natural_lde(step)
    wires_lde = wires_commitment.natural_lde(step)
    zs_pp_lde = zs_pp_commitment.natural_lde(step)
    device = wires_lde.device

    # coset points x, Z_H(x)^-1 (period 2^qdb) and L_0(x)
    x = gl.mul_const(gl.powers(ref.primitive_root_of_unity(
        common.degree_bits + qdb), N, device), g_shift)
    g_pow_n = ref.exp(g_shift, degree)
    v = ref.primitive_root_of_unity(qdb)
    zh = [ref.sub(ref.mul(g_pow_n, ref.exp(v, i)), 1)
          for i in range(next_step)]
    zh_t = gl.from_u64(np.asarray(zh, dtype=np.uint64),
                       device).repeat(N // next_step)
    zh_inv = gl.from_u64(np.asarray([ref.inverse(t) for t in zh],
                                    dtype=np.uint64),
                         device).repeat(N // next_step)
    l_0_x = gl.mul(zh_t, gl.inverse(gl.mul_const(
        gl.sub(x, gl.const(1, device)), degree % ref.ORDER)))

    consts_rows = cs_lde[:common.num_constants]
    sigmas_rows = cs_lde[common.num_constants:]
    next_zs_pp = torch.roll(zs_pp_lde, -next_step, dims=-1)
    pi_rows = gl.from_u64(np.asarray(public_inputs_hash, dtype=np.uint64),
                          device).unsqueeze(1).expand(4, N)
    constraint_rows = evaluate_gate_constraints_rows(
        common, consts_rows, wires_lde, pi_rows)

    routed = wires_lde[:nr]
    k = gl.from_u64(np.asarray(common.k_is, dtype=np.uint64),
                    device).unsqueeze(1)
    s_id = gl.mul(k, x)
    one = gl.const(1, device)
    pp_lo = common.partial_products_range.start
    num_prods = common.num_partial_products
    z1_terms, pp_terms = [], []
    for i in range(nc):
        z_x, z_gx = zs_pp_lde[i], next_zs_pp[i]
        z1_terms.append(gl.mul(l_0_x, gl.sub(z_x, one)))
        numer = gl.add_const(gl.add(routed, gl.mul_const(s_id, betas[i])),
                             gammas[i])
        denom = gl.add_const(gl.add(routed, gl.mul_const(sigmas_rows,
                                                          betas[i])),
                             gammas[i])
        nprod = _chunk_products(numer, qdf)
        dprod = _chunk_products(denom, qdf)
        pps = zs_pp_lde[pp_lo + i * num_prods:pp_lo + (i + 1) * num_prods]
        accs = torch.cat([z_x.unsqueeze(0), pps, z_gx.unsqueeze(0)])
        pp_terms.append(gl.sub(gl.mul(accs[:-1], nprod),
                               gl.mul(accs[1:], dprod)))
    terms = torch.cat([torch.stack(z1_terms)] + pp_terms + [constraint_rows])

    values = []
    for i in range(nc):
        apow = gl.powers(alphas[i], terms.shape[0], device).unsqueeze(1)
        values.append(gl.mul(gl.reduce_sum(gl.mul(terms, apow), 0), zh_inv))
    coeffs = ntt.coset_ifft(torch.stack(values), shift=g_shift)
    return coeffs[:, :qdf * degree].reshape(nc * qdf, degree)
