"""The PLONK wire matrix, milliseconds a proof: the span `wire matrix`
inside `witness upload` (the matrix built from the set representatives
and uploaded) of `prove` or `prove_batch`. None where the program opens no
such span."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"wire matrix", r"run generators( \(batch\))?")
