"""Vanishing-polynomial evaluation (plonky2_tpu/plonk/vanishing.py; reference
plonk/vanishing_poly.rs:43 at zeta, :118 over the LDE batch).

The prover evaluates every gate constraint over the whole LDE grid as int64
tensors (`evaluate_gate_constraints_rows`); the verifier evaluates the same
generic code at zeta on extension scalars (`eval_vanishing_poly_at_zeta`).
Over the grid, each gate with constraints is a scope `gate <id>` of the
thread's active TimingTree (`utils/timing.scope`).
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..gates.gate import EXT, GFAlgebra, compute_filter
from ..utils import timing as tracing


def _check_partial_products(alg, numerators, denominators, partials, z_x,
                            z_gx, max_degree: int):
    """prev_acc * prod(num_chunk) - next_acc * prod(den_chunk) per chunk
    (reference: util/partial_products.rs:55-78)."""
    accs = [z_x] + list(partials) + [z_gx]
    n = len(numerators)
    chunks = [(i, min(i + max_degree, n)) for i in range(0, n, max_degree)]
    assert len(chunks) == len(accs) - 1
    out = []
    for (lo, hi), prev_acc, next_acc in zip(chunks, accs[:-1], accs[1:]):
        nprod = numerators[lo]
        dprod = denominators[lo]
        for j in range(lo + 1, hi):
            nprod = alg.mul(nprod, numerators[j])
            dprod = alg.mul(dprod, denominators[j])
        out.append(alg.sub(alg.mul(prev_acc, nprod), alg.mul(next_acc, dprod)))
    return out


def evaluate_gate_constraints(alg, common, local_constants, local_wires,
                              pi_hash):
    """Sum of filtered per-gate constraints, bucketed by constraint index
    (reference: vanishing_poly.rs:563-626)."""
    num_selectors = common.selectors_info.num_selectors
    buckets = [None] * common.num_gate_constraints
    for i, gate in enumerate(common.gates):
        sel_idx = common.selectors_info.selector_indices[i]
        group = common.selectors_info.groups[sel_idx]
        filt = compute_filter(alg, i, group, local_constants[sel_idx],
                              num_selectors > 1)
        consts = local_constants[num_selectors:]
        for j, c in enumerate(gate.eval_unfiltered(alg, consts, local_wires,
                                                   pi_hash)):
            fc = alg.mul(filt, c)
            buckets[j] = fc if buckets[j] is None else alg.add(buckets[j], fc)
    return [b if b is not None else alg.zero() for b in buckets]


def evaluate_gate_constraints_rows(common, consts_rows: torch.Tensor,
                                   wires_rows: torch.Tensor,
                                   pi_rows: torch.Tensor) -> torch.Tensor:
    """Filtered gate constraints over the grid: [num_gate_constraints, N]."""
    N = wires_rows.shape[-1]
    num_selectors = common.selectors_info.num_selectors
    alg = GFAlgebra((N,), wires_rows.device)
    gate_consts = consts_rows[num_selectors:]
    total = torch.zeros((common.num_gate_constraints, N), dtype=torch.int64,
                        device=wires_rows.device)
    for i, gate in enumerate(common.gates):
        if gate.num_constraints() == 0:
            continue
        with tracing.scope(f"gate {gate.id()}", wires_rows.device):
            sel_idx = common.selectors_info.selector_indices[i]
            group = common.selectors_info.groups[sel_idx]
            filt = compute_filter(alg, i, group, consts_rows[sel_idx],
                                  num_selectors > 1)
            gc = gate.eval_unfiltered_rows(gate_consts, wires_rows, pi_rows)
            k = gc.shape[0]
            total[:k] = gl.add(total[:k], gl.mul(gc, filt))
    return total


def reduce_with_powers(alg, terms, alpha):
    """sum_i terms[i] * alpha^i, Horner from the top."""
    acc = alg.zero()
    for t in reversed(list(terms)):
        acc = alg.add(alg.mul(acc, alpha), t)
    return acc


def eval_vanishing_poly(alg, common, x, local_constants, local_wires,
                        pi_hash, local_zs, next_zs, partial_products,
                        s_sigmas, betas, gammas, alphas, l_0_x):
    """One combined vanishing value per challenge, generic over the
    algebra; betas/gammas/alphas are already-lifted algebra elements."""
    constraint_terms = evaluate_gate_constraints(alg, common, local_constants,
                                                 local_wires, pi_hash)
    nc = common.config.num_challenges
    nr = common.config.num_routed_wires
    num_prods = common.num_partial_products
    z1_terms, pp_terms = [], []
    one = alg.const(1)
    for i in range(nc):
        z_x, z_gx = local_zs[i], next_zs[i]
        z1_terms.append(alg.mul(l_0_x, alg.sub(z_x, one)))
        numerators, denominators = [], []
        for j in range(nr):
            w = local_wires[j]
            s_id = alg.mul_const(x, common.k_is[j])
            numerators.append(alg.add(alg.add(w, alg.mul(betas[i], s_id)),
                                      gammas[i]))
            denominators.append(
                alg.add(alg.add(w, alg.mul(betas[i], s_sigmas[j])),
                        gammas[i]))
        cur_pp = partial_products[i * num_prods:(i + 1) * num_prods]
        pp_terms.extend(_check_partial_products(
            alg, numerators, denominators, cur_pp, z_x, z_gx,
            common.quotient_degree_factor))
    terms = z1_terms + pp_terms + constraint_terms
    return [reduce_with_powers(alg, terms, alphas[i]) for i in range(nc)]


def eval_vanishing_poly_at_zeta(common, zeta, openings, pi_hash: list[int],
                                betas, gammas, alphas) -> list:
    n = common.degree
    # L_0(zeta) = (zeta^n - 1) / (n * (zeta - 1))
    num = ref.ext2_sub(ref.ext2_exp(zeta, n), (1, 0))
    den = ref.ext2_scalar_mul(ref.ext2_sub(zeta, (1, 0)), n % ref.ORDER)
    l_0 = ref.ext2_mul(num, ref.ext2_inverse(den))
    tup = lambda vs: [tuple(v) for v in vs]
    return eval_vanishing_poly(
        EXT, common, zeta, tup(openings.constants), tup(openings.wires),
        [(h, 0) for h in pi_hash], tup(openings.plonk_zs),
        tup(openings.plonk_zs_next), tup(openings.partial_products),
        tup(openings.plonk_sigmas), [EXT.const(b) for b in betas],
        [EXT.const(g) for g in gammas], [EXT.const(a) for a in alphas], l_0)
