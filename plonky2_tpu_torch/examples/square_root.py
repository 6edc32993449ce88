"""Square-root example (reference: plonky2/examples/square_root.rs): prove
knowledge of a square root of a public field element, the root found by a
custom witness generator; then round-trip the proof through its bytes.

    python -m plonky2_tpu_torch.examples.square_root [--device cpu]
"""

from ..field import reference as ref
from ..iop.generator import SimpleGenerator
from ..iop.witness import PartialWitness
from ..utils.serialization import (
    deserialize_proof_with_pis, serialize_proof_with_pis,
)
from ._common import builder as new_builder
from ._common import parse, run

X_VALUE = 8846460


class SquareRootGenerator(SimpleGenerator):
    """x_squared -> x = sqrt(x_squared) (reference: square_root.rs
    SquareRootGenerator)."""

    def __init__(self, x, x_squared):
        self.x, self.x_squared = x, x_squared

    def dependencies(self):
        return [self.x_squared]

    def run_once(self, witness, out):
        out.append((self.x, sqrt(witness.get(self.x_squared))))


def sqrt(a: int) -> int:
    """A square root of `a` in Goldilocks by Tonelli-Shanks: p = 1 mod 4,
    so the (p + 1) / 4 power does not apply; p - 1 = 2^32 q."""
    p = ref.ORDER
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        raise ValueError(f"{a} is not a quadratic residue")
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = ref.MULTIPLICATIVE_GROUP_GENERATOR    # a non-residue
    while pow(z, (p - 1) // 2, p) == 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def main(argv=None):
    """Returns (data, proof)."""
    args = parse(__doc__, argv)
    builder = new_builder(args.seed)
    x = builder.add_virtual_target()
    x_squared = builder.square(x)
    builder.register_public_input(x_squared)
    builder.add_simple_generator(SquareRootGenerator(x, x_squared))

    data = builder.build(device=args.device)
    x2_value = X_VALUE * X_VALUE % ref.ORDER
    pw = PartialWitness()
    pw.set_target(x_squared, x2_value)
    proof = data.prove(pw)
    print(f"proved knowledge of sqrt({x2_value})")
    data.verify(proof)

    blob = serialize_proof_with_pis(proof, data.common)
    restored = deserialize_proof_with_pis(blob, data.common)
    data.verify(restored)
    print(f"serialization roundtrip OK ({len(blob)} bytes)")
    return data, proof


if __name__ == "__main__":
    run(main)
