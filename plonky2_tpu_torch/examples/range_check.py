"""Range-check example (reference: plonky2/examples/range_check.rs): prove
that a public value lies in [0, 2^6).

    python -m plonky2_tpu_torch.examples.range_check [--device cpu]
"""

from ..iop.witness import PartialWitness
from ._common import builder as new_builder
from ._common import parse, run


def main(argv=None):
    """Returns (data, proof)."""
    args = parse(__doc__, argv)
    builder = new_builder(args.seed)
    value = builder.add_virtual_target()
    builder.range_check(value, 6)
    builder.register_public_input(value)

    data = builder.build(device=args.device)
    pw = PartialWitness()
    pw.set_target(value, 42)
    proof = data.prove(pw)
    print(f"value {proof.public_inputs[0]} is in [0, 2^6)")
    data.verify(proof)
    print("proof verified")
    return data, proof


if __name__ == "__main__":
    run(main)
