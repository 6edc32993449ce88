"""The FRI check of an opening proof on python ints (plonky2's
fri/verifier.rs and fri/challenges.rs, with the okx fork's final
polynomial multiplied by X).

A proof is handed over as plain data (see `benchmark/plain.py`):
  {"commit_caps": [cap, ...], "final_poly": [(c0, c1), ...],
   "pow_witness": int,
   "queries": [{"initial": [[leaf, path], ...],   # one per oracle
                "steps": [[evals, path], ...]}]}  # one per folding
where a cap and a path are lists of 4-element digests.

`instance` describes what was opened: the polynomial count of each oracle
and, per opening point, the point and the (oracle, polynomial) pairs
opened there, in order.
"""

from __future__ import annotations

from . import poseidon as ps
from .field import (
    GENERATOR, ONE, P, ZERO, as_ext, e_add, e_horner, e_inv, e_mul, e_pow,
    e_scale, e_sub, reverse_bits, root_of_unity,
)


class Refused(Exception):
    """The proof does not verify."""


def require(cond, why: str) -> None:
    if not cond:
        raise Refused(why)


def arity_bits(params: dict, degree_bits: int) -> list[int]:
    """The constant-arity reduction strategy: fold by 2^arity_bits while
    the degree exceeds 2^final_poly_bits and the folded layer still has
    2^cap_height cosets."""
    out = []
    db = degree_bits
    while (db > params["final_poly_bits"]
           and db + params["rate_bits"] - params["arity_bits"]
           >= params["cap_height"]):
        out.append(params["arity_bits"])
        db -= params["arity_bits"]
    return out


def _digest(d) -> tuple:
    d = tuple(int(x) for x in d)
    require(len(d) == 4 and all(0 <= x < P for x in d), "malformed digest")
    return d


def _cap(cap, cap_height: int) -> list[tuple]:
    require(len(cap) == 1 << cap_height, "cap of the wrong size")
    return [_digest(d) for d in cap]


def challenges(ch: ps.Challenger, proof: dict, params: dict,
               lde_bits: int, num_steps: int) -> dict:
    """The FRI part of the transcript, after the openings are observed."""
    alpha = ch.ext_challenge()
    require(len(proof["commit_caps"]) == num_steps,
            "wrong number of folding commitments")
    betas = []
    for cap in proof["commit_caps"]:
        ch.observe_cap(_cap(cap, params["cap_height"]))
        betas.append(ch.ext_challenge())
    ch.observe_ext([as_ext(c) for c in proof["final_poly"]])
    ch.observe([int(proof["pow_witness"])])
    pow_response = ch.challenge()
    indices = [ch.challenge() % (1 << lde_bits)
               for _ in range(params["num_query_rounds"])]
    return {"alpha": alpha, "betas": betas, "pow_response": pow_response,
            "indices": indices}


def _check_path(leaf, index: int, path, cap: list, depth: int) -> None:
    leaf = [int(x) for x in leaf]
    require(all(0 <= x < P for x in leaf), "leaf value outside the field")
    require(len(path) == depth, "Merkle path of the wrong length")
    root, cap_index = ps.merkle_root_of_path(leaf, index,
                                             [_digest(d) for d in path])
    require(root == cap[cap_index], "Merkle path does not reach the cap")


def _interpolate_at(x: int, index_in_coset: int, bits: int, evals, beta):
    """The value at beta of the polynomial through the coset of x: evals
    are its values at the coset's points in bit-reversed order."""
    arity = 1 << bits
    g = root_of_unity(bits)
    ys = [evals[reverse_bits(i, bits)] for i in range(arity)]
    start = x * pow(g, arity - reverse_bits(index_in_coset, bits), P) % P
    xs = [start * pow(g, i, P) % P for i in range(arity)]
    out = ZERO
    for i in range(arity):
        num = ONE
        den = 1
        for j in range(arity):
            if j != i:
                num = e_mul(num, e_sub(beta, (xs[j], 0)))
                den = den * (xs[i] - xs[j]) % P
        out = e_add(out, e_scale(e_mul(num, ys[i]), pow(den, P - 2, P)))
    return out


def verify(instance: dict, openings: list, caps: list, proof: dict,
           params: dict, degree_bits: int, ch: ps.Challenger) -> None:
    """Raise Refused unless the FRI proof opens `openings` (per point, the
    values in the instance's order) against the oracles' `caps`; `ch` is
    the transcript after the openings were observed."""
    steps = arity_bits(params, degree_bits)
    lde_bits = degree_bits + params["rate_bits"]
    cap_height = params["cap_height"]
    c = challenges(ch, proof, params, lde_bits, len(steps))
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
            _check_path(leaf, x_index, path, cap, lde_bits - cap_height)
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
                        layer_bits - cap_height)
            x = pow(x, 1 << bits, P)
            x_index = coset
        require(e_horner(final_poly, (x, 0)) == value,
                "final polynomial disagrees with the last fold")
