"""Carry a circuit built by the JAX package over to the port.

`circuit_data_from_arrays` takes the built circuit's state as numpy arrays
and host objects — the constants/sigmas commitment (coefficients, Merkle
leaves and digest layers), sigmas, subgroup, representative map, circuit
digest, generators, public-input targets and the CommonCircuitData — and
returns the port's CircuitData on `device`. Gates are rebuilt from their ids
as the port's gates. Nothing here imports JAX: the caller does the JAX ->
numpy step (GF.to_u64(), MerkleTree.leaves_host(), ...).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from plonky2_tpu.plonk.circuit_data import (
    CommonCircuitData, ProverOnlyData, VerifierOnlyData,
)
from plonky2_tpu.utils.bits import log2_strict

from .field import goldilocks as gl
from .fri.oracle import PolynomialBatch
from .gates.basic_gates import (
    ArithmeticGate, ConstantGate, NoopGate, PublicInputGate,
)
from .gates.poseidon_gate import PoseidonGate
from .hash.hashers import PoseidonGoldilocksConfig
from .hash.merkle import MerkleTree
from .plonk.circuit_data import CircuitData


def gate_from_id(gate_id: str):
    """The port's gate for a gate id of the JAX package."""
    fixed = {g.id(): g for g in (NoopGate(), PublicInputGate(),
                                 PoseidonGate())}
    if gate_id in fixed:
        return fixed[gate_id]
    m = re.fullmatch(r"ArithmeticGate \{ num_ops: (\d+) \}", gate_id)
    if m:
        return ArithmeticGate(int(m.group(1)))
    m = re.fullmatch(r"ConstantGate \{ num_consts: (\d+) \}", gate_id)
    if m:
        return ConstantGate(int(m.group(1)))
    raise NotImplementedError(f"gate not ported: {gate_id}")


def circuit_data_from_arrays(common: CommonCircuitData, *,
                             polynomials: np.ndarray, leaves: np.ndarray,
                             layers: list, sigmas: np.ndarray,
                             subgroup: np.ndarray,
                             representative_map: np.ndarray,
                             circuit_digest, generators: list,
                             public_inputs: list, device) -> CircuitData:
    """polynomials: uint64 [num_polys, degree] coefficients; leaves: uint64
    [lde_size, num_polys] in bit-reversed row order; layers: uint64 [m, 4]
    digest layers, leaf layer first and cap last."""
    if common.gc.name != PoseidonGoldilocksConfig.name:
        raise NotImplementedError(f"hasher config not ported: "
                                  f"{common.gc.name}")
    cap_height = common.config.fri_config.cap_height
    tree = MerkleTree(gl.from_u64(leaves, device), cap_height,
                      layers=[gl.from_u64(l, device) for l in layers])
    commitment = PolynomialBatch(
        gl.from_u64(polynomials, device), tree,
        log2_strict(polynomials.shape[-1]),
        common.config.fri_config.rate_bits)
    port_common = dataclasses.replace(
        common, gates=[gate_from_id(g.id()) for g in common.gates],
        gc=PoseidonGoldilocksConfig)
    digest = tuple(int(x) for x in circuit_digest)
    prover_only = ProverOnlyData(
        generators=list(generators),
        constants_sigmas_commitment=commitment,
        sigmas=np.asarray(sigmas, dtype=np.uint64),
        subgroup=np.asarray(subgroup, dtype=np.uint64),
        public_inputs=list(public_inputs),
        representative_map=np.asarray(representative_map, dtype=np.int64),
        circuit_digest=digest,
    )
    verifier_only = VerifierOnlyData(constants_sigmas_cap=tree.cap_digests(),
                                     circuit_digest=digest)
    return CircuitData(prover_only, verifier_only, port_common)
