"""The witness fixpoint's index of the generators that watch each
representative, milliseconds a proof: the span `generator index` of
`iop/generator.py` inside `run generators` (PLONK). None where the program
opens no such span."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"generator index", r"run generators")
