"""FRI's query rounds, milliseconds a proof: the span `FRI query rounds`
(the rows and Merkle paths read to the host and the rounds assembled)
inside `FRI opening proof` or the `FRI opening proof {b}` scopes, summed
over the call."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"FRI query rounds", r"FRI opening proof( \d+)?")
