"""Circuit configuration (reference: plonky2/src/plonk/circuit_data.rs:59-137)."""

from __future__ import annotations

import dataclasses

from ..fri.config import FriConfig, FriReductionStrategy


@dataclasses.dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = dataclasses.field(default_factory=FriConfig)

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        """reference: circuit_data.rs:98-116."""
        return CircuitConfig(
            fri_config=FriConfig(
                rate_bits=3,
                cap_height=4,
                proof_of_work_bits=16,
                reduction_strategy=FriReductionStrategy(
                    kind="constant_arity", arity_bits=4, final_poly_bits=5),
                num_query_rounds=28,
            ))

    @staticmethod
    def standard_ecc_config() -> "CircuitConfig":
        """136 wires for the u32 range-check gates of the ecdsa gadgets
        (reference: circuit_data.rs:118-123)."""
        return dataclasses.replace(CircuitConfig.standard_recursion_config(),
                                   num_wires=136)

    @staticmethod
    def wide_ecc_config() -> "CircuitConfig":
        """reference: circuit_data.rs:125-130."""
        return dataclasses.replace(CircuitConfig.standard_recursion_config(),
                                   num_wires=234)

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        """Blinding rows and salted oracles (reference:
        circuit_data.rs:132-137)."""
        return dataclasses.replace(CircuitConfig.standard_recursion_config(),
                                   zero_knowledge=True)
