"""The reference check of the recursion_leaf_d14_poseidon2 configuration:
recursion_leaf_d14's circuit under okx's Poseidon2GoldilocksConfig.

The layout (rows, selectors, constants and sigmas) is recursion_leaf_d14's:
the config changes no gate. Its constants-and-sigmas cap is committed here
with Poseidon2 in plain PyTorch (`plain_torch_poseidon2.py`), its circuit
digest is Poseidon2's hash_no_pad(cap, hash_pad([]), degree_bits), and each
proof is verified on python ints (`generic_verifier.py`) with Poseidon2's
Merkle paths and transcript. The public inputs are hashed with Poseidon, as
the circuit hashes them in its PoseidonGate row: okx's in-circuit Poseidon2
gadget is todo!() (hash/poseidon2.rs), so the config's InnerHasher
delegates to Poseidon.
"""

from __future__ import annotations

from . import common, plain_torch_poseidon2, poseidon, poseidon2
from . import recursion_leaf_d14 as leaf
from .generic_verifier import circuit_digest, verify as verify_generic
from .plonk import Circuit

HASHER = "Poseidon2GoldilocksConfig"
# (gates, selector groups, constants and sigmas [k + routed, n]): the
# leaf's, since the config changes no gate
layout = leaf.layout


def circuit(cfg: dict, device) -> Circuit:
    if cfg["hasher"] != HASHER:
        raise ValueError(f"the configuration states {cfg['hasher']}, the "
                         f"reference checks {HASHER}")
    gs, groups, values = layout(cfg)
    fri_cfg = cfg["fri"]
    cap = plain_torch_poseidon2.commitment_cap(
        values, fri_cfg["rate_bits"], fri_cfg["cap_height"], device)
    return Circuit(cfg=cfg, gates=gs, groups=groups,
                   num_constants=len(groups) + cfg["num_constants"],
                   cap=cap, digest=circuit_digest(cap, cfg["degree_bits"],
                                                  poseidon2))


def verify(c: Circuit, proof: dict, public_inputs: list) -> None:
    """Raise Refused unless `proof` proves the circuit with these public
    inputs: Poseidon2's trees and transcript, Poseidon's public-input
    hash."""
    verify_generic(c, proof, public_inputs, poseidon2, poseidon.hash_no_pad)


# what each number compared may read; both are counts of proofs
LIMITS = {"wrong_inputs": 0, "refused": 0}
# the control: proofs of work of 0 bits where the configuration states 16;
# the reference has to refuse its proofs
CONTROL = {"fri": {"proof_of_work_bits": 0}}


def check(cfg: dict, calls: list, sample: list, device) -> tuple:
    """The run's proofs (see `common.check`): each request's inputs are the
    public inputs its proof must carry."""
    c = circuit(cfg, device)
    return common.check(calls, sample, lambda pis: [int(x) for x in pis],
                        lambda proof, pis: verify(c, proof, pis), LIMITS)
