"""The witness tape: a recorded witness plan's lowered steps, run in the host
C library (`csrc/witness_tape.c`) over the typed witness store of
`iop/witness.py`.

A generator whose class has `tape_op()` lowers: the method gives its
opcode (one of those below), the targets it reads in a fixed order, its
build-time constants and the targets it writes, in the order its
`run_once` emits them. At recording (`iop/generator.py`) each such step of
the plan becomes an op over the representatives of those targets; a run of
consecutive ops becomes one `Tape`, which one C call runs. Each op
computes what its generator's `run_once` computes, bit for bit, and writes
as `PartitionWitness.set_rep` does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..field import reference as ref

POSEIDON = 1            # PoseidonGenerator: the gate's 122 trace columns
ARITHMETIC = 2          # c0 * m0 * m1 + c1 * z
ARITHMETIC_EXT = 3      # the same over F_{p^2}
MUL_EXT = 4             # c0 * m0 * m1 over F_{p^2}
REDUCING = 5            # acc = acc * alpha + coeff, base coefficients
REDUCING_EXT = 6        # the same, extension coefficients
RANDOM_ACCESS = 7       # the list's item at the index, the index's bits

# why an op did not complete (csrc/witness_tape.c)
OK, NOT_READY, CONFLICT, REFUSED = 0, 1, 2, 3

MAX_DEPS_OR_OUTS = 512  # csrc/witness_tape.c TAPE_MAX


def encode(op, rep, targets: tuple) -> list | None:
    """A generator's `tape_op()` as the ints of one op, its targets mapped
    by `rep`; None where it writes other targets than `targets`, the ones
    its step recorded, or has more dependencies or outputs than an op
    holds."""
    opcode, deps, consts, outs = op
    if tuple(outs) != targets or len(deps) > MAX_DEPS_OR_OUTS or \
            len(outs) > MAX_DEPS_OR_OUTS:
        return None
    return [opcode, len(deps), len(consts), len(outs),
            *(rep(t) for t in deps), *(c % ref.ORDER for c in consts),
            *(rep(t) for t in outs)]


class Tape:
    """Consecutive lowered steps of a plan: `ops`, their encoding (uint64),
    `steps`, the plan's steps they stand for, and `size`, the
    representatives of the store they were encoded for."""

    __slots__ = ("ops", "steps", "size")

    def __init__(self, ops: list, steps: list, size: int):
        self.ops = np.array(ops, dtype=np.uint64)
        self.steps = steps
        self.size = size

    def run(self, lib, witness) -> tuple[int, int]:
        """Run the ops over `witness`'s store, in order. -> (the ops that
        completed, OK or why the next one did not)."""
        if witness.values.size != self.size:
            raise ValueError(f"a tape of a store of {self.size} "
                             f"representatives, given {witness.values.size}")
        length = ctypes.c_int64(witness.num_set)
        status = ctypes.c_int32(OK)
        done = lib.witness_tape_run(
            self.ops.ctypes.data, len(self.steps), witness.values.ctypes.data,
            witness.flags.ctypes.data, witness.order.ctypes.data,
            ctypes.byref(length), ctypes.byref(status))
        witness.num_set = length.value
        return done, status.value
