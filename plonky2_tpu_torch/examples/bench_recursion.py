"""Recursion benchmark example (reference: plonky2's bench_recursion.rs):
prove a dummy circuit of 2^size rows, then build the circuit that verifies
its proof and prove that recursive wrap.

    python -m plonky2_tpu_torch.examples.bench_recursion [--size 12]
        [--device cpu]

Seconds are the host clock around work that ends in a synchronize. On the
CPU the wrap (2^12 rows or more, whatever the inner size) takes far longer
than on the card.
"""

from ..iop.witness import PartialWitness
from ..plonk.config import CircuitConfig
from ..recursion.dummy import dummy_circuit, dummy_proof
from ..recursion.targets import (
    add_virtual_proof_with_pis, add_virtual_verifier_data,
    set_proof_with_pis_target, set_verifier_data_target,
)
from ..recursion.verifier import verify_proof_circuit
from ._common import builder as new_builder
from ._common import clock, parse, run


def wrap_circuit(inner, seed):
    """The recursive verifier of `inner`'s proofs, the inner proof's public
    inputs its own: (unbuilt builder, witness of one inner proof)."""
    config = CircuitConfig.standard_recursion_config()
    builder = new_builder(seed)
    pt = add_virtual_proof_with_pis(builder, inner.common)
    vt = add_virtual_verifier_data(builder, config.fri_config.cap_height)
    verify_proof_circuit(builder, pt, vt, inner.common)
    builder.register_public_inputs(pt.public_inputs)

    def witness(proof) -> PartialWitness:
        pw = PartialWitness()
        set_proof_with_pis_target(pw, pt, proof)
        set_verifier_data_target(pw, vt, inner.verifier_only)
        return pw
    return builder, witness


def main(argv=None):
    """Returns (inner, inner_proof, outer, wrap_proof)."""
    args = parse(__doc__, argv, (("--size",), dict(
        type=int, default=12, help="log2 size of the inner dummy circuit")))
    config = CircuitConfig.standard_recursion_config()
    t0 = clock(args.device)
    inner, pis = dummy_circuit(config, args.size, 4, device=args.device)
    inner_proof = dummy_proof(inner, pis, {0: 42})
    inner.verify(inner_proof)
    t1 = clock(args.device)
    print(f"inner 2^{args.size} proof: {t1 - t0:.2f}s")

    builder, witness = wrap_circuit(inner, args.seed)
    outer = builder.build(device=args.device)
    t2 = clock(args.device)
    print(f"wrap circuit build (degree 2^{outer.common.degree_bits}): "
          f"{t2 - t1:.2f}s")

    wrap_proof = outer.prove(witness(inner_proof))
    t3 = clock(args.device)
    print(f"recursive wrap proof: {t3 - t2:.2f}s")
    outer.verify(wrap_proof)
    print(f"wrap verified; public inputs {wrap_proof.public_inputs}")
    return inner, inner_proof, outer, wrap_proof


if __name__ == "__main__":
    run(main)
