"""Circuit serialization example (reference: plonky2's
fibonacci_serialization.rs): build fib(100), save its CircuitData, load
it back and prove with the loaded circuit; the original verifies the proof.

    python -m plonky2_tpu_torch.examples.fibonacci_serialization
        [--device cpu] [--seed S]

The load is handed the builder's random stream when --seed is given (a
fresh generator of that seed), so the loaded circuit then proves the bytes
the original would.
"""

import numpy as np

from ..iop.witness import PartialWitness
from ..utils.circuit_serialization import (
    deserialize_circuit_data, serialize_circuit_data,
    serialize_prover_circuit_data, serialize_verifier_circuit_data,
)
from ._common import fib_circuit, parse, run


def main(argv=None):
    """Returns (data, restored, pw, proof): the built circuit, the loaded
    one, the witness and the loaded circuit's proof."""
    args = parse(__doc__, argv)
    builder, initial_a, initial_b, _ = fib_circuit(args.seed)
    data = builder.build(device=args.device)

    blob = serialize_circuit_data(data)
    prover = serialize_prover_circuit_data(data.prover_data())
    verifier = serialize_verifier_circuit_data(data.verifier_data())
    print(f"CircuitData: {len(blob)} bytes (prover split: {len(prover)}, "
          f"verifier split: {len(verifier)})")

    rng = None if args.seed is None else np.random.default_rng(args.seed)
    restored = deserialize_circuit_data(blob, device=args.device, rng=rng)
    pw = PartialWitness()
    pw.set_target(initial_a, 0)
    pw.set_target(initial_b, 1)
    proof = restored.prove(pw)
    print(f"100th Fibonacci number (mod p): {proof.public_inputs[2]}")
    data.verify(proof)  # the original accepts the reloaded prover's proof
    print("proof from reloaded circuit verified")
    return data, restored, pw, proof


if __name__ == "__main__":
    run(main)
