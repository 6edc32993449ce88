"""Fibonacci example (reference: plonky2/examples/fibonacci.rs): prove
knowledge of the 100th Fibonacci number from public initial values.

    python -m plonky2_tpu_torch.examples.fibonacci [--device cpu]
"""

from ..iop.witness import PartialWitness
from ._common import fib_circuit, parse, run


def main(argv=None):
    """Returns (data, proof)."""
    args = parse(__doc__, argv)
    builder, initial_a, initial_b, _ = fib_circuit(args.seed)
    data = builder.build(device=args.device)
    pw = PartialWitness()
    pw.set_target(initial_a, 0)
    pw.set_target(initial_b, 1)
    proof = data.prove(pw)
    print(f"100th Fibonacci number (mod p): {proof.public_inputs[2]}")
    data.verify(proof)
    print("proof verified")
    return data, proof


if __name__ == "__main__":
    run(main)
