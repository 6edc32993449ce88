"""The STARK prover's quotient, milliseconds a proof: the scope `compute
quotient polys` of `starky.prover.prove`."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"compute quotient polys",
                        r"compute trace commitment")
