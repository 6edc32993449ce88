"""The witness fixpoint's worklist, milliseconds a proof: the span
`generator passes` of `iop/generator.py` inside `run generators` (PLONK).
None where the program opens no such span."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"generator passes", r"run generators")
