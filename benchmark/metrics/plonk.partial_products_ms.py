"""Round 2 of the PLONK prover, milliseconds a proof: the scope `compute
partial products` of `prove`, or `partial products (batch)` of
`prove_batch` over its proofs."""

from benchmark.metrics.scopes import per_proof_ms

PLONK = r"run generators( \(batch\))?"


def read(ctx):
    return per_proof_ms(ctx, r"compute partial products|partial products "
                             r"\(batch\)", PLONK)
