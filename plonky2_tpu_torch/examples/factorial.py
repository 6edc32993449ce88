"""Factorial example (reference: plonky2/examples/factorial.rs): prove
knowledge of 100! starting from a public initial value.

    python -m plonky2_tpu_torch.examples.factorial [--device cpu]
"""

from ..iop.witness import PartialWitness
from ._common import builder as new_builder
from ._common import parse, run


def main(argv=None):
    """Returns (data, proof)."""
    args = parse(__doc__, argv)
    builder = new_builder(args.seed)
    initial = builder.add_virtual_target()
    cur = initial
    for i in range(2, 101):
        cur = builder.mul_const(i, cur)
    builder.register_public_input(initial)
    builder.register_public_input(cur)

    data = builder.build(device=args.device)
    pw = PartialWitness()
    pw.set_target(initial, 1)
    proof = data.prove(pw)
    print(f"100! (mod p): {proof.public_inputs[1]}")
    data.verify(proof)
    print("proof verified")
    return data, proof


if __name__ == "__main__":
    run(main)
