"""PermutationStark: a 3-column STARK whose only argument is a logUp lookup —
column 0's values must be a permutation of column 1's, with frequency column 2
(reference: starky/src/permutation_stark.rs:24-100)."""

from __future__ import annotations

import numpy as np

from ..field import reference as ref
from .lookup import Column, Lookup
from .stark import Stark


class PermutationStark(Stark):
    """State [i, j, 1] with transitions i'=i+1, j'=j+1; the last row's j is
    rewritten to x0 so columns 0 and 1 are permutations of each other."""

    COLUMNS = 3
    PUBLIC_INPUTS = 1

    def constraint_degree(self) -> int:
        return 0

    def lookups(self):
        return [Lookup(columns=(Column.single(0),),
                       table_column=Column.single(1),
                       frequencies_column=Column.single(2))]

    def eval(self, alg, frame, consumer) -> None:
        # no register constraints: the lookup argument is the whole statement
        pass

    def generate_trace(self, x0: int, num_rows: int) -> np.ndarray:
        col = (np.uint64(x0 % ref.ORDER)
               + np.arange(num_rows + 1, dtype=np.uint64))
        col = np.where(col >= np.uint64(ref.ORDER), col - np.uint64(ref.ORDER),
                       col)
        col1 = col[1:].copy()
        col1[-1] = x0
        return np.stack([col[:-1], col1, np.ones(num_rows, dtype=np.uint64)])
