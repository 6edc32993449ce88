"""Round 3's gate constraints, milliseconds a proof: the span `gate
constraints` (every gate's constraints over the LDE grid, summed over round
3's passes) of a PLONK prove or of `prove_batch`."""

from benchmark.metrics.scopes import per_proof_ms

PLONK = r"run generators( \(batch\))?"


def read(ctx):
    return per_proof_ms(ctx, r"gate constraints", PLONK)
