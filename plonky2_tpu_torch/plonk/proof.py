"""Proof containers (reference: plonky2/src/plonk/proof.rs — Proof:34,
OpeningSet:301, ProofChallenges:261)."""

from __future__ import annotations

import dataclasses

from ..fri.proof import FriProof
from ..fri.structure import FriChallenges, FriOpeningBatch, FriOpenings

E = tuple[int, int]


@dataclasses.dataclass
class OpeningSet:
    constants: list[E]
    plonk_sigmas: list[E]
    wires: list[E]
    plonk_zs: list[E]
    plonk_zs_next: list[E]
    partial_products: list[E]
    quotient_polys: list[E]

    def to_fri_openings(self) -> FriOpenings:
        """Batch order matters for Fiat-Shamir
        (reference: proof.rs:345-363)."""
        zeta_batch = FriOpeningBatch(values=tuple(
            self.constants + self.plonk_sigmas + self.wires + self.plonk_zs
            + self.partial_products + self.quotient_polys))
        zeta_next_batch = FriOpeningBatch(values=tuple(self.plonk_zs_next))
        return FriOpenings(batches=(zeta_batch, zeta_next_batch))


@dataclasses.dataclass
class Proof:
    """Each cap is 2^cap_height digests: tuples of 4 ints, or bytes under a
    byte-digest hasher (Keccak)."""
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: OpeningSet
    opening_proof: FriProof


@dataclasses.dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: list[int]


@dataclasses.dataclass
class ProofChallenges:
    plonk_betas: list[int]
    plonk_gammas: list[int]
    plonk_alphas: list[int]
    plonk_zeta: E
    fri_challenges: FriChallenges
