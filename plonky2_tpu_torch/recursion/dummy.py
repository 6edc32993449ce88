"""Dummy circuits and proofs (plonky2_tpu/recursion/dummy.py:21-70;
reference recursion/dummy_circuit.rs): a NoopGate-padded circuit of a given
degree with unconstrained public inputs — the base proof of a recursion
chain, and a circuit whose kernels run at the full size of its degree."""

from __future__ import annotations

from plonky2_tpu.iop.witness import PartialWitness
from plonky2_tpu.plonk.config import CircuitConfig

from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.circuit_data import CircuitData


def dummy_circuit(config: CircuitConfig, degree_bits: int,
                  num_public_inputs: int, *, device
                  ) -> tuple[CircuitData, list]:
    """Returns (data, pi_targets)."""
    builder = CircuitBuilder(config)
    pis = builder.add_virtual_targets(num_public_inputs)
    builder.register_public_inputs(pis)
    data = builder.build(device=device, min_degree_bits=degree_bits)
    assert data.common.degree_bits == degree_bits, \
        f"dummy circuit degree {data.common.degree_bits} != {degree_bits}"
    return data, pis


def dummy_proof(data: CircuitData, pi_targets: list,
                nonzero_public_inputs: dict[int, int] | None = None):
    """Prove the dummy circuit; unspecified public inputs are zero."""
    nonzero_public_inputs = nonzero_public_inputs or {}
    pw = PartialWitness()
    for i, t in enumerate(pi_targets):
        pw.set_target(t, nonzero_public_inputs.get(i, 0))
    return data.prove(pw)
