"""FRI's commit phase, milliseconds a proof: the span `fold codewords in
the commitment phase` (the folds, each with its Merkle tree, cap read and
beta draw) inside `FRI opening proof` of a PLONK or STARK prove, or inside
the `FRI opening proof {b}` scopes of `prove_batch`, summed over the
call."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"fold codewords in the commitment phase",
                        r"FRI opening proof( \d+)?")
