"""The reference check of the starky_fib_r20 configuration: starky's
FibonacciStark (starky/src/fibonacci_stark.rs) verified here on python ints
(starky's verifier.rs and get_challenges.rs), against public inputs worked
out here from the request's (x0, x1).

The table has two columns and 2^degree_bits rows; row 0 is (x0, x1) and
row i + 1 is (b, a + b) after row i = (a, b). Its constraints: the first
row equals the first two public inputs, each transition follows the rule,
and the last row's second column equals the third public input.
"""

from __future__ import annotations

from . import common, fri
from . import poseidon as ps
from .field import (
    ONE, P, as_ext, e_add, e_inv, e_mul, e_pow, e_scale, e_sub,
    root_of_unity,
)
from .fri import require

LIMITS = {"wrong_inputs": 0, "refused": 0}
# the control: the program with one stated guarantee broken, proofs of work
# of 2 bits where the configuration states 16 (the program grinds 2 bits at
# the least), the step that would tempt a faster prover; the reference has
# to refuse its proofs
CONTROL = {"fri": {"proof_of_work_bits": 2}}


def _fib_pair(k: int) -> tuple[int, int]:
    """(F(k), F(k + 1)) mod p by doubling, F(0) = 0, F(1) = 1."""
    if k == 0:
        return 0, 1
    a, b = _fib_pair(k >> 1)
    c = a * (2 * b - a) % P
    d = (a * a + b * b) % P
    return (d, (c + d) % P) if k & 1 else (c, d)


def public_inputs(cfg: dict, x0: int, x1: int) -> list[int]:
    """[x0, x1, the second column of the last row]: x0 F(n-1) + x1 F(n)."""
    f, f_next = _fib_pair((1 << cfg["degree_bits"]) - 1)
    return [x0 % P, x1 % P, (x0 * f + x1 * f_next) % P]


def verify(cfg: dict, proof: dict, pis: list[int]) -> None:
    """Raise Refused unless `proof` proves the table for these inputs."""
    fri_cfg = cfg["fri"]
    nc = cfg["num_challenges"]
    degree_bits = cfg["degree_bits"]
    n = 1 << degree_bits
    require([int(x) for x in proof["public_inputs"]] == pis,
            "public inputs differ from the table's")
    caps = proof["caps"]
    require(len(caps) == 2, "a FibonacciStark proof has two caps")
    op = {}
    for name, size in (("local_values", 2), ("next_values", 2),
                       ("quotient_polys", nc)):
        values = proof["openings"][name]
        require(len(values) == size, f"{name}: {len(values)} openings")
        op[name] = [as_ext(v) for v in values]

    ch = ps.Challenger()
    ch.observe_cap(caps[0])
    alphas = ch.challenges(nc)
    ch.observe_cap(caps[1])
    zeta = ch.ext_challenge()
    at_zeta = op["local_values"] + op["quotient_polys"]
    ch.observe_ext(at_zeta)
    ch.observe_ext(op["next_values"])

    g = root_of_unity(degree_bits)
    z_h = e_sub(e_pow(zeta, n), ONE)
    l_first = e_mul(z_h, e_inv(e_scale(e_sub(zeta, ONE), n)))
    l_last = e_mul(z_h, e_inv(e_scale(e_sub(e_scale(zeta, g), ONE), n)))
    z_last = e_sub(zeta, (pow(g, P - 2, P), 0))
    (a, b), (a2, b2) = op["local_values"], op["next_values"]
    pi = [(x, 0) for x in pis]
    constraints = [e_mul(e_sub(a, pi[0]), l_first),
                   e_mul(e_sub(b, pi[1]), l_first),
                   e_mul(e_sub(a2, b), z_last),
                   e_mul(e_sub(b2, e_add(a, b)), z_last),
                   e_mul(e_sub(b, pi[2]), l_last)]
    for i in range(nc):
        acc = (0, 0)
        for c in constraints:
            acc = e_add(e_mul(acc, (alphas[i], 0)), c)
        # constraint degree 2: one quotient chunk a challenge
        require(acc == e_mul(z_h, op["quotient_polys"][i]),
                f"quotient identity fails for challenge {i}")

    instance = {"oracle_sizes": [2, nc], "points": [
        (zeta, [(0, 0), (0, 1)] + [(1, i) for i in range(nc)]),
        (e_scale(zeta, g), [(0, 0), (0, 1)])]}
    fri.verify(instance, [at_zeta, op["next_values"]], caps, proof["fri"],
               fri_cfg, degree_bits, ch)


def check(cfg: dict, calls: list, sample: list, device) -> tuple:
    """The run's proofs (see `common.check`): each request's inputs are
    (x0, x1), and its proof must carry public_inputs(cfg, x0, x1)."""
    return common.check(calls, sample, lambda x: public_inputs(cfg, *x),
                        lambda proof, pis: verify(cfg, proof, pis), LIMITS)
