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
from ..utils import timing
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


class PartitionLayout:
    """The circuit-constant tables of its PartitionWitnesses, built once per
    circuit (`of`) and shared read-only by all its proofs: `rep_list`, the
    representative of each flat target index (a tuple: scalar numpy
    indexing costs ~10x a tuple index, and the generator fixpoint does
    millions of representative lookups), and the inverse map of the wire
    matrix, the slots of each representative: slot w * degree + i (wire w
    of row i) of representative r is in
    `rep_slots[rep_starts[r]:rep_starts[r + 1]]` (int64, read-only)."""

    def __init__(self, representative_map: np.ndarray, num_wires: int,
                 degree: int):
        self.num_wires = num_wires
        self.degree = degree
        self.rep_list = tuple(representative_map.tolist())
        # wires occupy flat target indices row*num_wires + col
        slot_reps = np.asarray(representative_map[:degree * num_wires],
                               dtype=np.int64).reshape(degree, num_wires)
        slot_reps = np.ascontiguousarray(slot_reps.T).reshape(-1)
        size = len(representative_map)
        if slot_reps.size and not (0 <= slot_reps.min()
                                   and slot_reps.max() < size):
            raise ValueError("a representative outside the target indices")
        self.rep_slots = np.argsort(slot_reps, kind="stable")
        self.rep_starts = np.zeros(size + 1, dtype=np.int64)
        np.cumsum(np.bincount(slot_reps, minlength=size),
                  out=self.rep_starts[1:])
        self.rep_slots.flags.writeable = False
        self.rep_starts.flags.writeable = False

    @classmethod
    def of(cls, prover_data, common) -> "PartitionLayout":
        """The layout of `prover_data`'s circuit, built at its first proof
        and kept on it (host memory only, never serialized)."""
        layout = getattr(prover_data, "_partition_layout", None)
        if layout is None:
            layout = prover_data._partition_layout = cls(
                prover_data.representative_map, common.config.num_wires,
                common.degree)
        return layout


class PartitionWitness:
    """Full witness keyed by union-find representative index; `set_reps`
    records the representatives `set` filled, in the order it filled
    them."""

    def __init__(self, layout, num_wires: int, degree: int):
        """`layout`: a PartitionLayout, or the circuit's representative
        map, from which one is built."""
        if not isinstance(layout, PartitionLayout):
            layout = PartitionLayout(layout, num_wires, degree)
        self.layout = layout
        self.rep_list = layout.rep_list
        self.num_wires = num_wires
        self.degree = degree
        self.values: list = [None] * len(layout.rep_list)
        self.set_reps: list[int] = []

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
        idx = self.rep_index(t)
        return idx if self.set_rep(idx, t, value) else None

    def set_rep(self, idx: int, t, value: int) -> bool:
        """`set` of target `t` whose representative `idx` the caller has;
        True if newly set."""
        value %= ref.ORDER
        prev = self.values[idx]
        if prev is not None:
            assert prev == value, \
                f"Partition containing {t} was set twice with different values: {prev} != {value}"
            return False
        self.values[idx] = value
        self.set_reps.append(idx)
        return True

    def full_witness(self) -> np.ndarray:
        """uint64 [num_wires, degree] wire matrix; unset wires are zero
        (reference: witness.rs full_witness -> MatrixWitness)."""
        return wire_matrix([self])[:, 0]


def wire_matrix(witnesses: list, out: np.ndarray | None = None
                ) -> np.ndarray:
    """uint64 [num_wires, B, degree]: the wire matrices of B witnesses of one
    circuit, unset wires zero, written into `out` when given. Only the set
    representatives are read: each one's value (canonical, as `set` reduces
    it) goes to its slots through the layout's inverse map, so the work
    follows the count of set representatives. Counts `wire_values`, the
    set representatives carried, on the thread's active TimingTree."""
    layout = witnesses[0].layout
    assert all(w.layout is layout for w in witnesses), \
        "the witnesses of one wire matrix share their circuit's layout"
    if out is None:
        out = np.zeros((layout.num_wires, len(witnesses), layout.degree),
                       dtype=np.uint64)
    else:
        out.fill(0)
    for b, w in enumerate(witnesses):
        values = w.values
        reps = np.array(w.set_reps, dtype=np.int64)
        first = layout.rep_starts[reps]
        counts = layout.rep_starts[reps + 1] - first
        # the slots of each set representative, one run after another
        runs = np.cumsum(counts) - counts
        slots = layout.rep_slots[np.arange(int(counts.sum()))
                                 + np.repeat(first - runs, counts)]
        wire, row = np.divmod(slots, layout.degree)
        out[wire, b, row] = np.repeat(
            np.array([values[r] for r in w.set_reps], dtype=np.uint64),
            counts)
        timing.count("wire_values", len(reps))
    return out
