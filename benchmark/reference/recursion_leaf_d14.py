"""The reference check of the recursion_leaf_d14 configuration: plonky2's
dummy circuit with its public inputs, laid out here from plonky2's
building rules, committed here in plain PyTorch, and each proof verified
here on python ints.

The circuit (plonky2 circuit_builder.rs build:1045-1265, in the order it
adds rows): row 0 a PoseidonGate hashing the public inputs into the state
[pi_0 .. pi_3, 0 x 8] with swap 0; row 1 the PublicInputGate, whose wires
0..3 are the hash's first four outputs; row 2 a ConstantGate that routes
the constant 0 (to the Poseidon inputs 4..11 and its swap wire); NoopGates
up to 2^degree_bits rows.
"""

from __future__ import annotations

import numpy as np

from . import common, plain_torch
from . import poseidon as ps
from .field import GENERATOR, P, e_add, e_mul, e_sub, root_of_unity
from .plonk import (
    UNUSED_SELECTOR, Circuit, Gate, circuit_digest, selector_groups, verify,
)

# PoseidonGate's wires (plonky2 gates/poseidon.rs): inputs, outputs, swap,
# the 4 swap deltas, the S-box inputs of full rounds 1-3, of the 22 partial
# rounds and of the last 4 full rounds
IN, OUT, SWAP, DELTA = 0, 12, 24, 25
FULL_0 = DELTA + 4
PARTIAL = FULL_0 + 3 * ps.WIDTH
FULL_1 = PARTIAL + ps.PARTIAL_ROUNDS
POSEIDON_WIRES = FULL_1 + ps.HALF_FULL_ROUNDS * ps.WIDTH     # 135


def _x7(x):
    x2 = e_mul(x, x)
    return e_mul(e_mul(e_mul(x2, x2), x2), x)


def _mds(state):
    return [(sum(m * s[0] for m, s in zip(row, state)) % P,
             sum(m * s[1] for m, s in zip(row, state)) % P)
            for row in ps.MDS_ROWS]


def poseidon_constraints(consts, w, pi_hash):
    """The gate's 123 constraints: the swap is boolean, the deltas swap the
    two input halves, each S-box input wire equals the state that reaches
    it, and the outputs equal the last state."""
    swap = w[SWAP]
    out = [e_mul(swap, e_sub(swap, (1, 0)))]
    for i in range(4):
        out.append(e_sub(e_mul(swap, e_sub(w[IN + 4 + i], w[IN + i])),
                         w[DELTA + i]))
    state = ([e_add(w[IN + i], w[DELTA + i]) for i in range(4)]
             + [e_sub(w[IN + 4 + i], w[DELTA + i]) for i in range(4)]
             + [w[IN + i] for i in range(8, ps.WIDTH)])
    for r in range(ps.ROUNDS):
        state = [e_add(s, (c, 0)) for s, c in zip(
            state, ps.ROUND_CONSTANTS[ps.WIDTH * r:ps.WIDTH * (r + 1)])]
        if r < ps.HALF_FULL_ROUNDS:
            wires = (range(FULL_0 + ps.WIDTH * (r - 1),
                           FULL_0 + ps.WIDTH * r) if r else [])
        elif r < ps.HALF_FULL_ROUNDS + ps.PARTIAL_ROUNDS:
            wires = [PARTIAL + r - ps.HALF_FULL_ROUNDS]
        else:
            first = FULL_1 + ps.WIDTH * (r - ps.HALF_FULL_ROUNDS
                                         - ps.PARTIAL_ROUNDS)
            wires = range(first, first + ps.WIDTH)
        for lane, wire in enumerate(wires):
            out.append(e_sub(state[lane], w[wire]))
            state[lane] = w[wire]
        full = not ps.HALF_FULL_ROUNDS <= r < ps.ROUNDS - ps.HALF_FULL_ROUNDS
        state = ([_x7(s) for s in state] if full
                 else [_x7(state[0])] + state[1:])
        state = _mds(state)
    out.extend(e_sub(s, w[OUT + i]) for i, s in enumerate(state))
    return out


def gates(cfg: dict) -> list[Gate]:
    """The circuit's gate types in selector order, by (degree, id) with
    plonky2's Debug-format ids."""
    k = cfg["num_constants"]
    found = [
        Gate("NoopGate", 0, 0, lambda c, w, h: []),
        Gate(f"ConstantGate {{ num_consts: {k} }}", 1, k,
             lambda c, w, h: [e_sub(c[i], w[i]) for i in range(k)]),
        Gate("PublicInputGate", 1, 4,
             lambda c, w, h: [e_sub(w[i], h[i]) for i in range(4)]),
        Gate("PoseidonGate(PhantomData<plonky2_field::goldilocks_field::"
             "GoldilocksField>)<WIDTH=12>", 7, 123, poseidon_constraints),
    ]
    return sorted(found, key=lambda g: (g.degree, g.id))


def layout(cfg: dict) -> tuple[list[Gate], list[range], np.ndarray]:
    """(gates, selector groups, constants and sigmas [k + routed, n])."""
    n = 1 << cfg["degree_bits"]
    nr = cfg["num_routed_wires"]
    if cfg["num_public_inputs"] > ps.RATE:
        raise ValueError("the layout hashes the public inputs in one row")
    if cfg["zero_knowledge"]:
        raise ValueError("the layout has no blinding rows")
    if cfg["num_wires"] < POSEIDON_WIRES:
        raise ValueError("the PoseidonGate needs 135 wires")
    gs = gates(cfg)
    index = {g.id.split(" ")[0].split("(")[0]: i for i, g in enumerate(gs)}
    groups = selector_groups(gs, cfg["max_quotient_degree_factor"] + 1)
    rows = ([index["PoseidonGate"], index["PublicInputGate"],
             index["ConstantGate"]] + [index["NoopGate"]] * (n - 3))
    selectors = np.full((len(groups), n), UNUSED_SELECTOR, dtype=np.uint64)
    for row, g in enumerate(rows):
        group = next(k for k, grp in enumerate(groups) if g in grp)
        selectors[group, row] = g
    gate_constants = np.zeros((cfg["num_constants"], n), dtype=np.uint64)

    # copy constraints among routed wires, each class in row-major order;
    # sigma sends a wire to the next of its class, cyclically
    num_pi = cfg["num_public_inputs"]
    zero_class = ([(0, IN + i) for i in range(num_pi, ps.WIDTH)]
                  + [(0, SWAP), (2, 0)])
    classes = [zero_class] + [[(0, OUT + i), (1, i)] for i in range(4)]
    next_wire = {}
    for cls in classes:
        cls = sorted(w for w in cls if w[1] < nr)
        for a, b in zip(cls, cls[1:] + cls[:1]):
            next_wire[a] = b
    k_is = [pow(GENERATOR, j, P) for j in range(nr)]
    omega = root_of_unity(cfg["degree_bits"])
    subgroup = np.asarray([pow(omega, i, P) for i in range(n)],
                          dtype=object)
    sigmas = np.empty((nr, n), dtype=object)
    for col in range(nr):
        sigmas[col] = subgroup * k_is[col] % P
    for (row, col), (nrow, ncol) in next_wire.items():
        sigmas[col, row] = k_is[ncol] * pow(omega, nrow, P) % P
    values = np.concatenate([selectors, gate_constants,
                             sigmas.astype(np.uint64)])
    return gs, groups, values


def circuit(cfg: dict, device) -> Circuit:
    gs, groups, values = layout(cfg)
    fri_cfg = cfg["fri"]
    cap = plain_torch.commitment_cap(values, fri_cfg["rate_bits"],
                                     fri_cfg["cap_height"], device)
    return Circuit(cfg=cfg, gates=gs, groups=groups,
                   num_constants=len(groups) + cfg["num_constants"],
                   cap=cap, digest=circuit_digest(cap, cfg["degree_bits"]))


# what each number compared may read; both are counts of proofs
LIMITS = {"wrong_inputs": 0, "refused": 0}
# the control: the program with one stated guarantee broken, proofs of work
# of 2 bits where the configuration states 16 (the program grinds 2 bits at
# the least), the step that would tempt a faster prover; the reference has
# to refuse its proofs
CONTROL = {"fri": {"proof_of_work_bits": 2}}


def check(cfg: dict, calls: list, sample: list, device) -> tuple:
    """The run's proofs (see `common.check`): each request's inputs are the
    public inputs its proof must carry."""
    c = circuit(cfg, device)
    return common.check(calls, sample, lambda pis: [int(x) for x in pis],
                        lambda proof, pis: verify(c, proof, pis), LIMITS)
