"""Batch prover: B witnesses of one circuit proved together, byte-identical
to B serial `prove` calls (reference semantics per proof: prover.rs:104-355;
the JAX package's plonk/batch_prover.py, which vmaps each phase).

The port's design is the proof axis of `prover.prove_many`: every tensor of
rounds 1-4 carries the B proofs ([rows, B, n] coefficients, [rows, B, N]
LDE values), so a commit's iNTT, coset LDE and leaf hash are one kernel call
for the B proofs, their B Merkle trees one call of the tree entry for each
binary run of B (one call when B is a power of two), the partial products
one scan and round 3's gate constraints one evaluation over the [W, B N]
grid. The host challengers and the query-bound FRI stay a loop over the
proofs.
"""

from __future__ import annotations

from ..utils.timing import TimingTree
from .prover import prove_many
from .proof import ProofWithPublicInputs

# the scope labels of a batch prove, in order (JAX package:
# plonk/batch_prover.py); the last is each proof's FRI, b its index
BATCH_SCOPES = ("run generators (batch)", "wires commitment (batch)",
                "partial products (batch)",
                "zs+partial_products commitment (batch)",
                "quotient polys (batch)", "quotient commitment (batch)",
                "openings at zeta (batch)", "FRI opening proof {b}")


def prove_batch(prover_data, common, inputs_list,
                timing: TimingTree | None = None
                ) -> list[ProofWithPublicInputs]:
    """One proof for each PartialWitness of `inputs_list`; `timing` scopes
    its phases under BATCH_SCOPES (see `prover.prove`). Under a
    zero-knowledge config each proof draws its own salts, so prove those
    serially; the trees need a device hasher (Poseidon, Poseidon2)."""
    assert not common.config.zero_knowledge, \
        "batch prover covers non-zk circuits; prove zk circuits serially"
    assert common.gc.hasher.device, \
        "batch prover needs a device (algebraic) hasher config"
    return prove_many(prover_data, common, list(inputs_list), timing,
                      scopes=BATCH_SCOPES)
