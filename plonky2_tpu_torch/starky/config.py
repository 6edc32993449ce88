"""StarkConfig (reference: starky/src/config.rs:19-60)."""

from __future__ import annotations

import dataclasses

from ..fri.config import FriConfig, FriParams, FriReductionStrategy


@dataclasses.dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = dataclasses.field(default_factory=FriConfig)

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig(fri_config=FriConfig(
            rate_bits=1,
            cap_height=4,
            proof_of_work_bits=16,
            reduction_strategy=FriReductionStrategy(
                kind="constant_arity", arity_bits=4, final_poly_bits=5),
            num_query_rounds=84,
        ))

    def fri_params(self, degree_bits: int) -> FriParams:
        return self.fri_config.fri_params(degree_bits, False)
