"""Witness containers (reference: plonky2/src/iop/witness.rs —
PartialWitness:267 user inputs; PartitionWitness:301 union-find-backed full
witness).

PartitionWitness stores one value per union-find representative; setting any
target in a copy-constraint partition sets the whole partition, which is how
`connect` equalities propagate with zero work at prove time.
"""

from __future__ import annotations

import numpy as np

from .. import host
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
    """Full witness keyed by union-find representative index, in a typed
    store: `values`, uint64 [representatives], canonical where set and 0
    where not; `flags`, uint8 [representatives], 1 where set; and the
    representatives set so far, in the order they were set (`set_reps`,
    an int64 view of a preallocated array, which `set` and the witness tape
    of iop/tape.py append to alike)."""

    def __init__(self, layout, num_wires: int, degree: int):
        """`layout`: a PartitionLayout, or the circuit's representative
        map, from which one is built."""
        if not isinstance(layout, PartitionLayout):
            layout = PartitionLayout(layout, num_wires, degree)
        self.layout = layout
        self.rep_list = layout.rep_list
        self.num_wires = num_wires
        self.degree = degree
        size = len(layout.rep_list)
        self.values = np.zeros(size, dtype=np.uint64)
        self.flags = np.zeros(size, dtype=np.uint8)
        # each representative is set at most once
        self.order = np.empty(size, dtype=np.int64)
        self.num_set = 0

    @property
    def set_reps(self) -> np.ndarray:
        """The representatives set so far, in the order they were set."""
        return self.order[:self.num_set]

    def rep_index(self, t) -> int:
        return self.rep_list[target_index(t, self.num_wires, self.degree)]

    def try_get(self, t) -> int | None:
        """The target's value, or None while it is unset."""
        idx = self.rep_index(t)
        return self.values.item(idx) if self.flags.item(idx) else None

    def is_set(self, t) -> bool:
        return bool(self.flags.item(self.rep_index(t)))

    def get(self, t) -> int:
        idx = self.rep_index(t)
        assert self.flags.item(idx), f"target {t} not set"
        return self.values.item(idx)

    def set(self, t, value: int) -> int | None:
        """Returns the representative index if newly set, else None
        (reference: witness.rs set_target_returning_rep:320)."""
        idx = self.rep_index(t)
        return idx if self.set_rep(idx, t, value) else None

    def set_rep(self, idx: int, t, value: int) -> bool:
        """`set` of target `t` whose representative `idx` the caller has;
        True if newly set."""
        value = int(value) % ref.ORDER
        if self.flags.item(idx):
            prev = self.values.item(idx)
            assert prev == value, \
                f"Partition containing {t} was set twice with different values: {prev} != {value}"
            return False
        self.values[idx] = value
        self.flags[idx] = 1
        self.order[self.num_set] = idx
        self.num_set += 1
        return True

    def as_list(self) -> list:
        """The value of each representative as an int, None where unset."""
        return [v if f else None
                for v, f in zip(self.values.tolist(), self.flags.tolist())]

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
    follows the count of set representatives; in the host C library where
    it is built and the degree a power of two (`csrc/witness_tape.c`
    `wire_matrix_fill`), else in numpy.
    Counts `wire_values`, the set representatives carried, on the thread's
    active TimingTree."""
    layout = witnesses[0].layout
    assert all(w.layout is layout for w in witnesses), \
        "the witnesses of one wire matrix share their circuit's layout"
    shape = (layout.num_wires, len(witnesses), layout.degree)
    if out is None:
        out = np.zeros(shape, dtype=np.uint64)
    elif out.shape != shape:
        raise ValueError(f"a wire matrix of {shape}, given {out.shape}")
    else:
        out.fill(0)
    log_degree = layout.degree.bit_length() - 1
    lib = host.load() if layout.degree == 1 << log_degree and \
        out.flags.c_contiguous and out.dtype == np.uint64 else None
    for b, w in enumerate(witnesses):
        reps = w.set_reps
        if lib is not None:
            lib.wire_matrix_fill(
                w.values.ctypes.data, w.order.ctypes.data, len(reps),
                layout.rep_starts.ctypes.data, layout.rep_slots.ctypes.data,
                log_degree, len(witnesses), b, out.ctypes.data)
        else:
            first = layout.rep_starts[reps]
            counts = layout.rep_starts[reps + 1] - first
            # the slots of each set representative, one run after another
            runs = np.cumsum(counts) - counts
            slots = layout.rep_slots[np.arange(int(counts.sum()))
                                     + np.repeat(first - runs, counts)]
            wire, row = np.divmod(slots, layout.degree)
            out[wire, b, row] = np.repeat(w.values[reps], counts)
        timing.count("wire_values", len(reps))
    return out
