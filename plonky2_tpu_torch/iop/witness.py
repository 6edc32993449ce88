"""Witness containers (reference: plonky2/src/iop/witness.rs —
PartialWitness:267 user inputs; PartitionWitness:301 union-find-backed full
witness).

PartitionWitness stores one value per union-find representative; setting any
target in a copy-constraint partition sets the whole partition, which is how
`connect` equalities propagate with zero work at prove time.
"""

from __future__ import annotations

import numpy as np

from ..field import reference as ref
from .target import target_index


class PartialWitness:
    """User-supplied inputs: target -> int value."""

    def __init__(self):
        self.values: dict = {}

    def set_target(self, t, value: int) -> None:
        value %= ref.ORDER
        prev = self.values.get(t)
        assert prev is None or prev == value, f"conflicting value for {t}"
        self.values[t] = value

    def set_targets(self, pairs) -> None:
        """set_target for each (target, value) pair."""
        for t, v in pairs:
            self.set_target(t, v)


class PartitionWitness:
    """Full witness keyed by union-find representative index."""

    def __init__(self, representative_map: np.ndarray, num_wires: int,
                 degree: int):
        self.rep = representative_map  # flat index -> representative index
        # python-list mirror: scalar numpy indexing costs ~10x a list index,
        # and the generator fixpoint does millions of rep lookups
        self.rep_list = representative_map.tolist()
        self.num_wires = num_wires
        self.degree = degree
        self.values: list = [None] * len(representative_map)

    def rep_index(self, t) -> int:
        return self.rep_list[target_index(t, self.num_wires, self.degree)]

    def try_get(self, t) -> int | None:
        """The target's value, or None while it is unset."""
        return self.values[self.rep_index(t)]

    def is_set(self, t) -> bool:
        return self.values[self.rep_index(t)] is not None

    def get(self, t) -> int:
        v = self.values[self.rep_index(t)]
        assert v is not None, f"target {t} not set"
        return v

    def set(self, t, value: int) -> int | None:
        """Returns the representative index if newly set, else None
        (reference: witness.rs set_target_returning_rep:320)."""
        value %= ref.ORDER
        idx = self.rep_index(t)
        prev = self.values[idx]
        if prev is not None:
            assert prev == value, \
                f"Partition containing {t} was set twice with different values: {prev} != {value}"
            return None
        self.values[idx] = value
        return idx

    def full_witness(self) -> np.ndarray:
        """uint64 [num_wires, degree] wire matrix; unset wires are zero
        (reference: witness.rs full_witness -> MatrixWitness)."""
        # wires occupy flat indices row*num_wires + col
        flat = np.asarray(
            [v if v is not None else 0
             for v in (self.values[r] for r in
                       self.rep_list[: self.degree * self.num_wires])],
            dtype=np.uint64,
        )
        return flat.reshape(self.degree, self.num_wires).T.copy()
