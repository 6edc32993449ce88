"""Copy-constraint union-find and sigma polynomials.

Reference: plonky2/src/plonk/permutation_argument.rs — Forest:13-107,
get_sigma_polys:116-131, get_sigma_map:136-159.

The forest is host-side (circuit compile time). The sigma-polynomial
evaluation (k_i * subgroup[row] per routed wire) is vectorized with numpy.
"""

from __future__ import annotations

import numpy as np

from ..field import reference as ref
from ..iop.target import target_index


class Forest:
    def __init__(self, num_wires: int, num_routed_wires: int, degree: int):
        self.num_wires = num_wires
        self.num_routed_wires = num_routed_wires
        self.degree = degree
        self.parents = list(range(num_wires * degree))

    def add_virtual(self, count: int) -> None:
        base = len(self.parents)
        self.parents.extend(range(base, base + count))

    def _index(self, t) -> int:
        return target_index(t, self.num_wires, self.degree)

    def find(self, x: int) -> int:
        p = self.parents
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != x:
            p[x], x = root, p[x]
        return root

    def merge(self, tx, ty) -> None:
        x = self.find(self._index(tx))
        y = self.find(self._index(ty))
        if x != y:
            self.parents[y] = x

    def compress_paths(self) -> np.ndarray:
        for i in range(len(self.parents)):
            self.find(i)
        return np.asarray(self.parents, dtype=np.int64)

    def sigma_vecs(self, k_is: list[int], subgroup: np.ndarray) -> np.ndarray:
        """uint64 [num_routed_wires, degree] sigma polynomial values.

        sigma maps each routed wire to the *next* wire in its partition
        (cyclically); sigma poly value = k[next.column] * subgroup[next.row].
        """
        n, nr = self.degree, self.num_routed_wires
        # Representative of every routed wire: [n, nr]
        reps = np.asarray(self.parents, dtype=np.int64)[
            : n * self.num_wires].reshape(n, self.num_wires)[:, :nr]

        # Build "next in partition" by chaining wires that share a rep, in
        # (row, column) scan order — matching the reference's partition
        # construction (wire_partition + get_sigma_map), where each subset
        # lists wires in insertion order and neighbor = next element cyclically.
        # Reference scans row-major (row 0..n, column 0..nr) when building the
        # partition lists.
        flat_reps = reps.reshape(-1)  # index = row * nr + col
        first: dict[int, int] = {}
        prev: dict[int, int] = {}
        nxt = np.empty(n * nr, dtype=np.int64)
        for idx in range(n * nr):
            r = int(flat_reps[idx])
            if r in prev:
                nxt[prev[r]] = idx
            else:
                first[r] = idx
            prev[r] = idx
        for r, last in prev.items():
            nxt[last] = first[r]

        next_row = nxt // nr
        next_col = nxt % nr
        k_arr = np.asarray(k_is, dtype=np.uint64)
        # value = k[next_col] * subgroup[next_row] mod p — do it in python-int
        # vector form via object dtype only at the boundary; use u128 emulation:
        kv = k_arr[next_col].astype(object)
        sv = subgroup[next_row].astype(object)
        vals = np.asarray([(int(a) * int(b)) % ref.ORDER
                           for a, b in zip(kv, sv)], dtype=np.uint64)
        # output layout [nr, n]: sigma poly j has values over rows
        return vals.reshape(n, nr).T.copy()
