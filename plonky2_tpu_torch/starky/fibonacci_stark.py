"""FibonacciStark fixture (reference: starky/src/fibonacci_stark.rs:25-100).

Columns: (x0, x1); transition x0' = x1, x1' = x0 + x1; public inputs
(x0_init, x1_init, res) with res checked on the last row.
"""

from __future__ import annotations

import numpy as np

from ..field import reference as ref
from .stark import ConstraintConsumer, EvaluationFrame, Stark


class FibonacciStark(Stark):
    COLUMNS = 2
    PUBLIC_INPUTS = 3

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def constraint_degree(self) -> int:
        return 2

    def eval(self, alg, frame: EvaluationFrame,
             consumer: ConstraintConsumer) -> None:
        pis = frame.public_inputs
        # x0 starts at PI[0], x1 at PI[1]
        consumer.constraint_first_row(alg.sub(frame.local_values[0], pis[0]))
        consumer.constraint_first_row(alg.sub(frame.local_values[1], pis[1]))
        # x0' <- x1 ; x1' <- x0 + x1
        consumer.constraint_transition(
            alg.sub(frame.next_values[0], frame.local_values[1]))
        consumer.constraint_transition(
            alg.sub(frame.next_values[1],
                    alg.add(frame.local_values[0], frame.local_values[1])))
        # result on the last row
        consumer.constraint_last_row(alg.sub(frame.local_values[1], pis[2]))

    def generate_trace(self, x0: int, x1: int) -> np.ndarray:
        """uint64 [2, num_rows]."""
        col0, col1 = [], []
        for _ in range(self.num_rows):
            col0.append(x0)
            col1.append(x1)
            x0, x1 = x1, (x0 + x1) % ref.ORDER
        return np.asarray([col0, col1], dtype=np.uint64)
