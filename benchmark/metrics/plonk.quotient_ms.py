"""Round 3 of the PLONK prover, milliseconds a proof: the scope `compute
quotient polys` of `prove`, or `quotient polys (batch)` of `prove_batch`
over its proofs."""

from benchmark.metrics.scopes import per_proof_ms

PLONK = r"run generators( \(batch\))?"


def read(ctx):
    return per_proof_ms(ctx, r"compute quotient polys|quotient polys "
                             r"\(batch\)", PLONK)
