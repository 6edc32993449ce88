"""Batch proving example: B witnesses of the fib(100) circuit proved in one
`prove_batch` call (rounds 1-4 carry the B proofs in every tensor), each
proof equal to a serial `prove` of its witness.

    python -m plonky2_tpu_torch.examples.batch_prove [B] [--device cpu]

B defaults to 4; the i-th witness starts the sequence at (i, i + 1).
Seconds are the host clock around work that ends in a synchronize.
"""

from ..iop.witness import PartialWitness
from ..plonk.batch_prover import prove_batch
from ._common import clock, fib_circuit, parse, run


def witnesses(a, b, B: int) -> list:
    """The B witnesses: initial values (i, i + 1) of the i-th."""
    out = []
    for i in range(B):
        pw = PartialWitness()
        pw.set_target(a, i)
        pw.set_target(b, i + 1)
        out.append(pw)
    return out


def main(argv=None):
    """Returns (data, proofs)."""
    args = parse(__doc__, argv, (("B",), dict(
        type=int, nargs="?", default=4, help="proofs in the batch")))
    builder, a, b, _ = fib_circuit(args.seed)
    t0 = clock(args.device)
    data = builder.build(device=args.device)
    print(f"build: {clock(args.device) - t0:.2f}s "
          f"(degree 2^{data.common.degree_bits})")

    t0 = clock(args.device)
    proofs = prove_batch(data.prover_only, data.common,
                         witnesses(a, b, args.B))
    dt = clock(args.device) - t0
    for p in proofs:
        data.verify(p)
    print(f"{args.B} proofs in {dt:.2f}s ({args.B / dt:.2f} proofs/s), "
          f"all verified")
    print("fib(100) for (a=0,b=1):",
          proofs[0].public_inputs[2] if args.B else None)
    return data, proofs


if __name__ == "__main__":
    run(main)
