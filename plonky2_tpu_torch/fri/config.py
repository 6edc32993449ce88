"""FRI configuration (reference: plonky2/src/fri/mod.rs:26-113;
reduction_strategies.rs:11-57, the constant-arity strategy)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FriReductionStrategy:
    kind: str = "constant_arity"
    arity_bits: int = 4
    final_poly_bits: int = 5

    def reduction_arity_bits(self, degree_bits: int, rate_bits: int,
                             cap_height: int) -> tuple[int, ...]:
        if self.kind != "constant_arity":
            raise NotImplementedError(f"FRI reduction strategy {self.kind}")
        result = []
        db = degree_bits
        while (db > self.final_poly_bits
               and db + rate_bits - self.arity_bits >= cap_height):
            assert db >= self.arity_bits
            result.append(self.arity_bits)
            db -= self.arity_bits
        return tuple(result)


@dataclasses.dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    reduction_strategy: FriReductionStrategy = FriReductionStrategy()
    num_query_rounds: int = 28

    def fri_params(self, degree_bits: int, hiding: bool = False) -> "FriParams":
        rab = self.reduction_strategy.reduction_arity_bits(
            degree_bits, self.rate_bits, self.cap_height)
        return FriParams(config=self, hiding=hiding, degree_bits=degree_bits,
                         reduction_arity_bits=rab)

    @property
    def num_cap_elements(self) -> int:
        return 1 << self.cap_height


@dataclasses.dataclass(frozen=True)
class FriParams:
    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: tuple[int, ...]

    @property
    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def lde_size(self) -> int:
        return 1 << self.lde_bits

    @property
    def final_poly_bits(self) -> int:
        return self.degree_bits - self.total_arities

    @property
    def final_poly_len(self) -> int:
        return 1 << self.final_poly_bits
