"""The PLONK check of a proof on python ints (plonky2's plonk/verifier.rs,
get_challenges.rs and vanishing_poly.rs at zeta), for a circuit described
by `Circuit`: its gates in selector order, each with its constraints, and
its verifier key, which the caller works out.

A proof is handed over as plain data (see `benchmark/plain.py`):
  {"public_inputs": [...], "caps": [wires, zs_partial_products, quotient],
   "openings": {"constants", "plonk_sigmas", "wires", "plonk_zs",
                "plonk_zs_next", "partial_products", "quotient_polys"},
   "fri": {...}}
"""

from __future__ import annotations

import dataclasses

from . import fri
from . import poseidon as ps
from .field import (
    GENERATOR, ONE, P, as_ext, e_add, e_horner, e_inv, e_mul, e_pow, e_scale,
    e_sub, root_of_unity,
)
from .fri import require

UNUSED_SELECTOR = (1 << 32) - 1


@dataclasses.dataclass
class Gate:
    id: str
    degree: int
    num_constraints: int
    # (constants, wires, public-input hash) -> constraint values, all over
    # the extension
    constraints: object


@dataclasses.dataclass
class Circuit:
    cfg: dict
    gates: list            # in selector order: sorted by (degree, id)
    groups: list           # selector groups, ranges of gate indices
    num_constants: int     # selector polynomials + gate constants
    cap: list              # the constants-and-sigmas commitment's cap
    digest: tuple

    @property
    def degree_bits(self) -> int:
        return self.cfg["degree_bits"]


def selector_groups(gates: list, max_degree: int) -> list[range]:
    """plonky2's gates/selectors.rs: one selector for all gates when that
    keeps every filtered constraint within max_degree; else consecutive
    groups, each as long as its size plus its next gate's degree stays
    below max_degree."""
    n = len(gates)
    if gates[-1].degree + n - 1 <= max_degree:
        return [range(n)]
    groups, start = [], 0
    while start < n:
        size = 0
        while start + size < n and size + gates[start + size].degree \
                < max_degree:
            size += 1
        groups.append(range(start, start + size))
        start += size
    return groups


def circuit_digest(cap: list, degree_bits: int) -> tuple:
    return ps.hash_no_pad([x for d in cap for x in d] + list(ps.hash_pad([]))
                          + [degree_bits])


def _filter(index: int, group: range, s, many_selectors: bool):
    acc = ONE
    others = [i for i in group if i != index]
    if many_selectors:
        others.append(UNUSED_SELECTOR)
    for i in others:
        acc = e_mul(acc, e_sub((i, 0), s))
    return acc


def _gate_terms(circuit: Circuit, consts, wires, pi_hash) -> list:
    num_selectors = len(circuit.groups)
    width = max(g.num_constraints for g in circuit.gates)
    terms = [(0, 0)] * width
    for i, gate in enumerate(circuit.gates):
        group_index = next(k for k, grp in enumerate(circuit.groups)
                           if i in grp)
        filt = _filter(i, circuit.groups[group_index], consts[group_index],
                       num_selectors > 1)
        values = gate.constraints(consts[num_selectors:], wires, pi_hash)
        for j, c in enumerate(values):
            terms[j] = e_add(terms[j], e_mul(filt, c))
    return terms


def _openings(proof: dict, circuit: Circuit) -> dict:
    cfg = circuit.cfg
    nc = cfg["num_challenges"]
    qdf = cfg["max_quotient_degree_factor"]
    num_pp = -(-cfg["num_routed_wires"] // qdf) - 1
    sizes = {"constants": circuit.num_constants,
             "plonk_sigmas": cfg["num_routed_wires"],
             "wires": cfg["num_wires"], "plonk_zs": nc, "plonk_zs_next": nc,
             "partial_products": nc * num_pp, "quotient_polys": nc * qdf}
    out = {}
    for name, size in sizes.items():
        values = proof["openings"][name]
        require(len(values) == size, f"{name}: {len(values)} openings")
        out[name] = [as_ext(v) for v in values]
    return out


def verify(circuit: Circuit, proof: dict, public_inputs: list) -> None:
    """Raise Refused unless `proof` proves the circuit with these public
    inputs, under the configuration's FRI parameters."""
    cfg = circuit.cfg
    fri_cfg = cfg["fri"]
    nc = cfg["num_challenges"]
    qdf = cfg["max_quotient_degree_factor"]
    nr = cfg["num_routed_wires"]
    n = 1 << circuit.degree_bits
    require([int(x) for x in proof["public_inputs"]]
            == [int(x) for x in public_inputs],
            "public inputs differ from the request's")
    caps = proof["caps"]
    require(len(caps) == 3, "a PLONK proof has three caps")
    op = _openings(proof, circuit)
    pi_hash = ps.hash_no_pad(public_inputs)

    ch = ps.Challenger()
    ch.observe(circuit.digest)
    ch.observe(pi_hash)
    ch.observe_cap(caps[0])
    betas = ch.challenges(nc)
    gammas = ch.challenges(nc)
    ch.observe_cap(caps[1])
    alphas = ch.challenges(nc)
    ch.observe_cap(caps[2])
    zeta = ch.ext_challenge()
    at_zeta = (op["constants"] + op["plonk_sigmas"] + op["wires"]
               + op["plonk_zs"] + op["partial_products"]
               + op["quotient_polys"])
    ch.observe_ext(at_zeta)
    ch.observe_ext(op["plonk_zs_next"])

    # the vanishing polynomial at zeta
    zeta_n = e_pow(zeta, n)
    z_h = e_sub(zeta_n, ONE)
    l_0 = e_mul(z_h, e_inv(e_scale(e_sub(zeta, ONE), n)))
    gate_terms = _gate_terms(circuit, op["constants"], op["wires"],
                             [(h, 0) for h in pi_hash])
    k_is = [pow(GENERATOR, j, P) for j in range(nr)]
    num_pp = -(-nr // qdf) - 1
    z1_terms, pp_terms = [], []
    for i in range(nc):
        z_x, z_gx = op["plonk_zs"][i], op["plonk_zs_next"][i]
        z1_terms.append(e_mul(l_0, e_sub(z_x, ONE)))
        beta, gamma = (betas[i], 0), (gammas[i], 0)
        nums, dens = [], []
        for j in range(nr):
            w = op["wires"][j]
            nums.append(e_add(e_add(w, e_mul(beta, e_scale(zeta, k_is[j]))),
                              gamma))
            dens.append(e_add(e_add(w, e_mul(beta, op["plonk_sigmas"][j])),
                              gamma))
        accs = ([z_x] + op["partial_products"][i * num_pp:(i + 1) * num_pp]
                + [z_gx])
        for c, lo in enumerate(range(0, nr, qdf)):
            num_prod, den_prod = ONE, ONE
            for j in range(lo, min(lo + qdf, nr)):
                num_prod = e_mul(num_prod, nums[j])
                den_prod = e_mul(den_prod, dens[j])
            pp_terms.append(e_sub(e_mul(accs[c], num_prod),
                                  e_mul(accs[c + 1], den_prod)))
    terms = z1_terms + pp_terms + gate_terms
    for i in range(nc):
        vanishing = e_horner(terms, (alphas[i], 0))
        quotient = e_horner(op["quotient_polys"][i * qdf:(i + 1) * qdf],
                            zeta_n)
        require(vanishing == e_mul(z_h, quotient),
                f"vanishing identity fails for challenge {i}")

    g = root_of_unity(circuit.degree_bits)
    num_zs_pp = nc * (1 + num_pp)
    sizes = [circuit.num_constants + nr, cfg["num_wires"], num_zs_pp,
             nc * qdf]
    instance = {"oracle_sizes": sizes, "points": [
        (zeta, [(o, i) for o, size in enumerate(sizes)
                for i in range(size)]),
        (e_scale(zeta, g), [(2, i) for i in range(nc)])]}
    fri.verify(instance, [at_zeta, op["plonk_zs_next"]],
               [circuit.cap] + list(caps), proof["fri"], fri_cfg,
               circuit.degree_bits, ch)
