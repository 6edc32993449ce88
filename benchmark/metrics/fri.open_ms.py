"""FRI, milliseconds a proof: the scope `FRI opening proof` of a PLONK or
STARK prove, or the `FRI opening proof {b}` scopes of `prove_batch`,
summed over the call."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"FRI opening proof( \d+)?",
                        r"FRI opening proof( \d+)?")
