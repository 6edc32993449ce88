"""The reference check of the recursion_wrap_d13 configuration: the
recursive verifier circuit of a recursion_leaf_d14 proof, whose public
inputs are the leaf proof's public inputs and the leaf's verifier key.

The reference does not lay the wrap out: that would be a second copy of
plonky2's in-circuit verifier. It takes the wrap's verifier key pinned in
the configuration (the constants-and-sigmas cap and the circuit digest,
which a test ties to the JAX package's layout of the same circuit), gives
each of the configuration's gate ids its constraints (`gates.py`, and the
leaf's own gates for the four it shares), and verifies each proof on
python ints as for the leaf: the transcript, the vanishing identity at
zeta, every Merkle path and FRI. Each proof must carry the request's
public inputs followed by the leaf's verifier key as `recursion_leaf_d14`
works it out, so a wrap verifies only a leaf laid out as the reference
lays it out.
"""

from __future__ import annotations

from . import common
from . import gates as wrap_gates
from . import recursion_leaf_d14 as leaf
from .plonk import Circuit, circuit_digest, selector_groups, verify


def gate(gate_id: str, cfg: dict):
    """The reference's gate of `gate_id`; raises ValueError on an id it has
    no constraints for."""
    for g in leaf.gates(cfg):
        if g.id == gate_id:
            return g
    return wrap_gates.from_id(gate_id)


def circuit(cfg: dict) -> Circuit:
    """The wrap as the verifier sees it: the configuration's gates in
    selector order and its pinned verifier key."""
    gs = [gate(gate_id, cfg) for gate_id in cfg["gates"]]
    if gs != sorted(gs, key=lambda g: (g.degree, g.id)):
        raise ValueError("the gates are not in selector order")
    groups = selector_groups(gs, cfg["max_quotient_degree_factor"] + 1)
    if len(groups) != cfg["selector_groups"]:
        raise ValueError(f"{len(groups)} selector groups, the configuration "
                         f"states {cfg['selector_groups']}")
    key = cfg["verifier_key"]
    cap = [tuple(int(x) for x in d) for d in key["constants_sigmas_cap"]]
    digest = tuple(int(x) for x in key["circuit_digest"])
    if digest != circuit_digest(cap, cfg["degree_bits"]):
        raise ValueError("the pinned circuit digest is not that of the cap")
    return Circuit(cfg=cfg, gates=gs, groups=groups,
                   num_constants=len(groups) + cfg["num_constants"],
                   cap=cap, digest=digest)


def inner_key(cfg: dict, device) -> list[int]:
    """The leaf's verifier key as public inputs: its cap, digest by
    digest, then its circuit digest, worked out by `recursion_leaf_d14`."""
    c = leaf.circuit(cfg["inner_config"], device)
    return [x for d in c.cap for x in d] + list(c.digest)


# what each number compared may read; both are counts of proofs
LIMITS = {"wrong_inputs": 0, "refused": 0}
# the control: the wrap's proofs of work of 0 bits where the configuration
# states 16; the leaf and the layout are unchanged, and the reference has
# to refuse the wrap's proofs
CONTROL = {"fri": {"proof_of_work_bits": 0}}


def check(cfg: dict, calls: list, sample: list, device) -> tuple:
    """The run's proofs (see `common.check`): each request's inputs, then
    the leaf's verifier key, are the public inputs its proof must carry."""
    c = circuit(cfg)
    key = inner_key(cfg, device)
    return common.check(calls, sample,
                        lambda pis: [int(x) for x in pis] + key,
                        lambda proof, pis: verify(c, proof, pis), LIMITS)
