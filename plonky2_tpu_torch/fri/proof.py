"""FRI proof containers, host-side (reference: plonky2/src/fri/proof.rs)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FriQueryStep:
    evals: list            # arity extension elements: [(c0, c1), ...]
    merkle_proof: np.ndarray  # [levels, 4] uint64 (or [levels, 25] uint8)


@dataclasses.dataclass
class FriInitialTreeProof:
    # per oracle: (leaf values uint64 [leaf_size], merkle proof as above)
    evals_proofs: list

    def unsalted_eval(self, oracle_index: int, poly_index: int,
                      salted: bool) -> int:
        evals = self.evals_proofs[oracle_index][0]
        salt = 4 if salted else 0
        assert poly_index < len(evals) - salt
        return int(evals[poly_index])


@dataclasses.dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: list  # [FriQueryStep]


@dataclasses.dataclass
class FriProof:
    commit_phase_merkle_caps: list  # each: 2^cap_height digests
    query_round_proofs: list        # [FriQueryRound]
    final_poly: list                # [(c0, c1)] extension coeffs
    pow_witness: int
