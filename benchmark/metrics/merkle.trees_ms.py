"""The Merkle trees' builds, milliseconds a proof: the span `merkle trees`
(each tree's leaf hash and its layers: the PLONK commitments in
`fri/oracle.py`, each FRI commit-phase tree in `hash/merkle.py`), summed
over the call. None where the program opens no such span."""

from benchmark.metrics.scopes import per_proof_ms


def read(ctx):
    return per_proof_ms(ctx, r"merkle trees", r"merkle trees")
