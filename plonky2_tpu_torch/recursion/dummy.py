"""Dummy circuits and proofs (reference recursion/dummy_circuit.rs): a
NoopGate-padded circuit of a given degree with unconstrained public inputs — the base proof of a recursion
chain, and a circuit whose kernels run at the full size of its degree."""

from __future__ import annotations

from ..hash.hashers import PoseidonGoldilocksConfig
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.circuit_data import CircuitData
from ..plonk.config import CircuitConfig


def dummy_circuit(config: CircuitConfig, degree_bits: int,
                  num_public_inputs: int, *, device="cuda",
                  gc=PoseidonGoldilocksConfig) -> tuple[CircuitData, list]:
    """Returns (data, pi_targets); the circuit is committed on `device`
    under the hasher config `gc`."""
    builder = CircuitBuilder(config)
    pis = builder.add_virtual_targets(num_public_inputs)
    builder.register_public_inputs(pis)
    data = builder.build(device=device, min_degree_bits=degree_bits, gc=gc)
    assert data.common.degree_bits == degree_bits, \
        f"dummy circuit degree {data.common.degree_bits} != {degree_bits}"
    return data, pis


def dummy_witness(pi_targets: list,
                  nonzero_public_inputs: dict[int, int] | None = None
                  ) -> PartialWitness:
    """The dummy circuit's inputs; unspecified public inputs are zero."""
    nonzero_public_inputs = nonzero_public_inputs or {}
    pw = PartialWitness()
    for i, t in enumerate(pi_targets):
        pw.set_target(t, nonzero_public_inputs.get(i, 0))
    return pw


def dummy_proof(data: CircuitData, pi_targets: list,
                nonzero_public_inputs: dict[int, int] | None = None):
    """Prove the dummy circuit; unspecified public inputs are zero."""
    return data.prove(dummy_witness(pi_targets, nonzero_public_inputs))
