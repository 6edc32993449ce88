"""CircuitData of the port: the shared containers of
plonky2_tpu/plonk/circuit_data.py (CommonCircuitData, ProverOnlyData,
VerifierOnlyData) with prove/verify bound to the port's prover and
verifier. The constants/sigmas commitment in ProverOnlyData is the port's
PolynomialBatch, and a proof runs on its device."""

from __future__ import annotations

import dataclasses

from plonky2_tpu.plonk.circuit_data import (
    CommonCircuitData, ProverOnlyData, VerifierOnlyData,
)


@dataclasses.dataclass
class CircuitData:
    prover_only: ProverOnlyData
    verifier_only: VerifierOnlyData
    common: CommonCircuitData

    def prove(self, inputs):
        from .prover import prove
        return prove(self.prover_only, self.common, inputs)

    def verify(self, proof_with_pis) -> None:
        from .verifier import verify
        verify(proof_with_pis, self.verifier_only, self.common)
