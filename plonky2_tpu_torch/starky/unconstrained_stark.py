"""UnconstrainedStark — an empty STARK (proof of knowledge of a trace)
fixture (reference: starky/src/unconstrained_stark.rs:22-80). Exercises the
prover/verifier with zero constraints: the proof is a bare commitment +
FRI opening."""

from __future__ import annotations

import numpy as np

from ..field import reference as ref
from .stark import ConstraintConsumer, EvaluationFrame, Stark


class UnconstrainedStark(Stark):
    COLUMNS = 2
    PUBLIC_INPUTS = 0

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def constraint_degree(self) -> int:
        return 3

    def eval(self, alg, frame: EvaluationFrame,
             consumer: ConstraintConsumer) -> None:
        pass  # no constraints — any trace verifies

    def generate_trace(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, ref.ORDER, size=(self.COLUMNS, self.num_rows),
                            dtype=np.uint64)
