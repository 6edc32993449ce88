"""Circuit data containers (reference: plonky2/src/plonk/circuit_data.rs —
CommonCircuitData:415, ProverOnlyCircuitData:336, VerifierOnlyCircuitData:392,
CircuitData:158 with prove:186 / verify:195 / compress:204, and the
Prover-, Verifier- and MockCircuitData splits). The constants/sigmas
commitment in ProverOnlyData is the port's PolynomialBatch, and a proof runs
on its device."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..field import reference as ref
from ..fri.config import FriParams
from ..fri.structure import (
    FriBatchInfo, FriInstanceInfo, FriOracleInfo, FriPolynomialInfo,
)


@dataclasses.dataclass(frozen=True)
class SelectorsInfo:
    selector_indices: list[int]
    groups: list[range]

    @property
    def num_selectors(self) -> int:
        return len(self.groups)


# PlonkOracle indices (reference: plonk/plonk_common.rs:19-40)
class PlonkOracle:
    CONSTANTS_SIGMAS = (0, False)
    WIRES = (1, True)
    ZS_PARTIAL_PRODUCTS = (2, True)
    QUOTIENT = (3, True)


@dataclasses.dataclass
class CommonCircuitData:
    config: "CircuitConfig"
    fri_params: FriParams
    gates: list
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: list[int]
    num_partial_products: int
    # hashing configuration (reference: the C type parameter of
    # CircuitData<F, C, D>, plonk/config.rs:115-208)
    gc: "GenericConfig"

    def same_shape(self, other: "CommonCircuitData") -> bool:
        """Equal in every field, gates compared by id (the reference
        derives PartialEq on CommonCircuitData, circuit_data.rs:415): a
        proof of one circuit fits the verifier of the other."""
        return (self.config == other.config
                and self.fri_params == other.fri_params
                and self.gc.name == other.gc.name
                and [g.id() for g in self.gates] == [g.id()
                                                     for g in other.gates]
                and self.selectors_info == other.selectors_info
                and self.quotient_degree_factor == other.quotient_degree_factor
                and self.num_gate_constraints == other.num_gate_constraints
                and self.num_constants == other.num_constants
                and self.num_public_inputs == other.num_public_inputs
                and self.k_is == other.k_is
                and self.num_partial_products == other.num_partial_products)

    @property
    def degree_bits(self) -> int:
        return self.fri_params.degree_bits

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    # ranges into the committed batches (reference: circuit_data.rs:495-520)
    @property
    def constants_range(self) -> range:
        return range(0, self.num_constants)

    @property
    def sigmas_range(self) -> range:
        return range(self.num_constants,
                     self.num_constants + self.config.num_routed_wires)

    @property
    def zs_range(self) -> range:
        return range(0, self.config.num_challenges)

    @property
    def partial_products_range(self) -> range:
        return range(self.config.num_challenges,
                     (self.num_partial_products + 1) * self.config.num_challenges)

    @property
    def num_preprocessed_polys(self) -> int:
        return self.sigmas_range.stop

    @property
    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    @property
    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    def get_fri_instance(self, zeta) -> FriInstanceInfo:
        """All polys at zeta; Z polys also at g*zeta
        (reference: circuit_data.rs:526-546)."""
        zeta_batch = FriBatchInfo(point=tuple(zeta),
                                  polynomials=tuple(self._fri_all_polys()))
        g = ref.primitive_root_of_unity(self.degree_bits)
        zeta_next = ref.ext2_scalar_mul(zeta, g)
        zeta_next_batch = FriBatchInfo(
            point=tuple(zeta_next),
            polynomials=tuple(FriPolynomialInfo.from_range(
                PlonkOracle.ZS_PARTIAL_PRODUCTS[0],
                self.zs_range.start, self.zs_range.stop)))
        return FriInstanceInfo(oracles=tuple(self._fri_oracles()),
                               batches=(zeta_batch, zeta_next_batch))

    def _fri_oracles(self):
        return [
            FriOracleInfo(num_polys=self.num_preprocessed_polys,
                          blinding=PlonkOracle.CONSTANTS_SIGMAS[1]),
            FriOracleInfo(num_polys=self.config.num_wires,
                          blinding=PlonkOracle.WIRES[1]),
            FriOracleInfo(num_polys=self.num_zs_partial_products_polys,
                          blinding=PlonkOracle.ZS_PARTIAL_PRODUCTS[1]),
            FriOracleInfo(num_polys=self.num_quotient_polys,
                          blinding=PlonkOracle.QUOTIENT[1]),
        ]

    def _fri_all_polys(self):
        return (FriPolynomialInfo.from_range(0, 0, self.num_preprocessed_polys)
                + FriPolynomialInfo.from_range(1, 0, self.config.num_wires)
                + FriPolynomialInfo.from_range(
                    2, 0, self.num_zs_partial_products_polys)
                + FriPolynomialInfo.from_range(3, 0, self.num_quotient_polys))


@dataclasses.dataclass
class ProverOnlyData:
    generators: list
    constants_sigmas_commitment: "PolynomialBatch"
    sigmas: np.ndarray              # uint64 [num_routed_wires, degree]
    subgroup: np.ndarray            # uint64 [degree]
    public_inputs: list
    representative_map: np.ndarray  # int64 flat target index -> rep index
    circuit_digest: tuple           # or bytes under a byte-digest hasher


@dataclasses.dataclass
class VerifierOnlyData:
    constants_sigmas_cap: list      # 2^cap_height digests
    circuit_digest: tuple           # or bytes under a byte-digest hasher


@dataclasses.dataclass
class CircuitData:
    prover_only: ProverOnlyData
    verifier_only: VerifierOnlyData
    common: CommonCircuitData

    def prove(self, inputs, timing=None, rng=None):
        """`timing` (a TimingTree) and `rng`: see `plonk/prover.py`."""
        from .prover import prove
        return prove(self.prover_only, self.common, inputs, timing, rng)

    def verify(self, proof_with_pis) -> None:
        from .verifier import verify
        verify(proof_with_pis, self.verifier_only, self.common)

    def compress(self, proof_with_pis):
        """reference: circuit_data.rs:204-218."""
        from .compressed_proof import compress_proof
        return compress_proof(proof_with_pis,
                              self.verifier_only.circuit_digest, self.common)

    def decompress(self, compressed):
        from .compressed_proof import decompress_proof
        return decompress_proof(compressed,
                                self.verifier_only.circuit_digest,
                                self.common)

    def verify_compressed(self, compressed) -> None:
        self.verify(self.decompress(compressed))

    # splits (reference: circuit_data.rs:232-249)
    def prover_data(self) -> "ProverCircuitData":
        return ProverCircuitData(prover_only=self.prover_only,
                                 common=self.common)

    def verifier_data(self) -> "VerifierCircuitData":
        return VerifierCircuitData(verifier_only=self.verifier_only,
                                   common=self.common)

    def mock(self) -> "MockCircuitData":
        return MockCircuitData(prover_only=self.prover_only,
                               common=self.common)


@dataclasses.dataclass
class ProverCircuitData:
    """The prover's split (reference: circuit_data.rs:253-292)."""
    prover_only: ProverOnlyData
    common: CommonCircuitData

    def prove(self, inputs, timing=None, rng=None):
        from .prover import prove
        return prove(self.prover_only, self.common, inputs, timing, rng)


@dataclasses.dataclass
class VerifierCircuitData:
    """The verifier's split (reference: circuit_data.rs:296-332)."""
    verifier_only: VerifierOnlyData
    common: CommonCircuitData

    def verify(self, proof_with_pis) -> None:
        from .verifier import verify
        verify(proof_with_pis, self.verifier_only, self.common)

    def verify_compressed(self, compressed) -> None:
        from .compressed_proof import decompress_proof
        self.verify(decompress_proof(
            compressed, self.verifier_only.circuit_digest, self.common))


@dataclasses.dataclass
class MockCircuitData:
    """Witness generation without proving (reference:
    circuit_data.rs:142-155)."""
    prover_only: ProverOnlyData
    common: CommonCircuitData

    def generate_witness(self, inputs):
        from ..iop.generator import generate_partial_witness
        return generate_partial_witness(inputs, self.prover_only, self.common)
