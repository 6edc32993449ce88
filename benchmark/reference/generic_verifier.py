"""The PLONK and FRI checks of `plonk.py` and `fri.py` with the hasher as an
argument, for a configuration whose Merkle trees and transcript hash with
another permutation than Poseidon.

`hasher` is one of the reference's hash modules (`poseidon`, `poseidon2`):
its `hash_no_pad` and `hash_pad` give the circuit digest, its
`merkle_root_of_path` checks every Merkle path, and its `Challenger` is the
transcript. `pi_hash` hashes the public inputs: plonky2's InnerHasher,
which must equal the circuit's own in-circuit hash of them, a PoseidonGate
row, so it is Poseidon's under every config whose in-circuit gadget is
Poseidon's. What is free of the hash (the circuit, its selectors, the
openings, the gate terms, FRI's challenges and folds) is that of
`plonk.py` and `fri.py`.
"""

from __future__ import annotations

from . import fri
from .field import (
    GENERATOR, ONE, P, ZERO, as_ext, e_add, e_horner, e_inv, e_mul, e_pow,
    e_scale, e_sub, reverse_bits, root_of_unity,
)
from .fri import _cap, _digest, _interpolate_at, arity_bits, require
from .plonk import Circuit, _gate_terms, _openings


def circuit_digest(cap: list, degree_bits: int, hasher) -> tuple:
    return hasher.hash_no_pad([x for d in cap for x in d]
                              + list(hasher.hash_pad([])) + [degree_bits])


def verify(circuit: Circuit, proof: dict, public_inputs: list, hasher,
           pi_hash) -> None:
    """Raise Refused unless `proof` proves the circuit with these public
    inputs, under the configuration's FRI parameters (`plonk.verify`)."""
    cfg = circuit.cfg
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
    pis_digest = pi_hash(public_inputs)

    ch = hasher.Challenger()
    ch.observe(circuit.digest)
    ch.observe(pis_digest)
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
                             [(h, 0) for h in pis_digest])
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
    fri_verify(instance, [at_zeta, op["plonk_zs_next"]],
               [circuit.cap] + list(caps), proof["fri"], cfg["fri"],
               circuit.degree_bits, ch, hasher)


def _check_path(leaf, index: int, path, cap: list, depth: int,
                hasher) -> None:
    leaf = [int(x) for x in leaf]
    require(all(0 <= x < P for x in leaf), "leaf value outside the field")
    require(len(path) == depth, "Merkle path of the wrong length")
    root, cap_index = hasher.merkle_root_of_path(leaf, index,
                                                 [_digest(d) for d in path])
    require(root == cap[cap_index], "Merkle path does not reach the cap")


def fri_verify(instance: dict, openings: list, caps: list, proof: dict,
               params: dict, degree_bits: int, ch, hasher) -> None:
    """Raise Refused unless the FRI proof opens `openings` against the
    oracles' `caps` (`fri.verify`); `ch` is the transcript after the
    openings were observed."""
    steps = arity_bits(params, degree_bits)
    lde_bits = degree_bits + params["rate_bits"]
    cap_height = params["cap_height"]
    c = fri.challenges(ch, proof, params, lde_bits, len(steps))
    require(c["pow_response"] < 1 << (64 - params["proof_of_work_bits"]),
            "proof of work below the configured bits")
    queries = proof["queries"]
    require(len(queries) == params["num_query_rounds"],
            "wrong number of query rounds")
    final_len = 1 << (degree_bits - sum(steps))
    final_poly = [as_ext(v) for v in proof["final_poly"]]
    require(len(final_poly) == final_len, "final polynomial of wrong length")
    caps = [_cap(cap, cap_height) for cap in caps]
    commit_caps = [_cap(cap, cap_height) for cap in proof["commit_caps"]]
    alpha = c["alpha"]
    reduced = [e_horner(values, alpha) for values in openings]
    sizes = instance["oracle_sizes"]
    omega = root_of_unity(lde_bits)
    for x_index, query in zip(c["indices"], queries):
        initial = query["initial"]
        require(len(initial) == len(sizes), "wrong number of initial trees")
        for (leaf, path), cap, size in zip(initial, caps, sizes):
            require(len(leaf) == size, "leaf of the wrong width")
            _check_path(leaf, x_index, path, cap, lde_bits - cap_height,
                        hasher)
        x = GENERATOR * pow(omega, reverse_bits(x_index, lde_bits), P) % P
        total = ZERO
        for (point, polys), red in zip(instance["points"], reduced):
            evals = [(int(initial[o][0][i]), 0) for o, i in polys]
            numerator = e_sub(e_horner(evals, alpha), red)
            total = e_add(e_mul(total, e_pow(alpha, len(polys))),
                          e_mul(numerator, e_inv(e_sub((x, 0), point))))
        value = e_mul(total, (x, 0))
        require(len(query["steps"]) == len(steps), "wrong number of folds")
        layer_bits = lde_bits
        for (evals, path), bits, beta, cap in zip(
                query["steps"], steps, c["betas"], commit_caps):
            evals = [as_ext(v) for v in evals]
            require(len(evals) == 1 << bits, "fold of the wrong arity")
            coset, within = x_index >> bits, x_index & ((1 << bits) - 1)
            require(evals[within] == value, "fold inconsistent with layer")
            value = _interpolate_at(x, within, bits, evals, beta)
            layer_bits -= bits
            _check_path([v for e in evals for v in e], coset, path, cap,
                        layer_bits - cap_height, hasher)
            x = pow(x, 1 << bits, P)
            x_index = coset
        require(e_horner(final_poly, (x, 0)) == value,
                "final polynomial disagrees with the last fold")
