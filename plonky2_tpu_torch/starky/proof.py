"""STARK proof containers (reference: starky/src/proof.rs:30-260), host
objects as the PLONK proof's: openings are (c0, c1) pairs of python ints,
caps lists of host digests."""

from __future__ import annotations

import dataclasses

from ..fri.proof import FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings

E = tuple[int, int]


@dataclasses.dataclass
class StarkOpeningSet:
    local_values: list[E]
    next_values: list[E]
    quotient_polys: list[E]
    auxiliary_polys: list[E] | None = None
    auxiliary_polys_next: list[E] | None = None
    ctl_zs_first: list[int] | None = None   # base-field openings at x=1

    def to_fri_openings(self) -> FriOpenings:
        aux = self.auxiliary_polys or []
        aux_next = self.auxiliary_polys_next or []
        zeta_batch = FriOpeningBatch(
            values=tuple(self.local_values + aux + self.quotient_polys))
        zeta_next_batch = FriOpeningBatch(
            values=tuple(self.next_values + aux_next))
        batches = [zeta_batch, zeta_next_batch]
        if self.ctl_zs_first is not None:
            batches.append(FriOpeningBatch(
                values=tuple((v, 0) for v in self.ctl_zs_first)))
        return FriOpenings(batches=tuple(batches))


@dataclasses.dataclass
class StarkProof:
    trace_cap: list
    quotient_polys_cap: list
    openings: StarkOpeningSet
    opening_proof: FriProof
    auxiliary_polys_cap: list | None = None


@dataclasses.dataclass
class StarkProofWithPublicInputs:
    proof: StarkProof
    public_inputs: list[int]


@dataclasses.dataclass
class MultiProof:
    """Proofs for a multi-STARK (CTL-linked) system plus the shared CTL
    challenges (reference: starky/src/proof.rs:192-230)."""
    stark_proofs: list[StarkProofWithPublicInputs]
    ctl_challenges: list[tuple[int, int]]
