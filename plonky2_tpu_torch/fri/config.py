"""FRI configuration (reference: plonky2/src/fri/mod.rs:26-113;
reduction_strategies.rs:11-174: the fixed, constant-arity and min-size
strategies)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FriReductionStrategy:
    kind: str = "constant_arity"     # "fixed" | "constant_arity" | "min_size"
    fixed: tuple[int, ...] = ()
    arity_bits: int = 4
    final_poly_bits: int = 5
    max_arity_bits: Optional[int] = None

    def reduction_arity_bits(self, degree_bits: int, rate_bits: int,
                             cap_height: int,
                             num_queries: int) -> tuple[int, ...]:
        if self.kind == "fixed":
            return tuple(self.fixed)
        if self.kind == "constant_arity":
            result = []
            db = degree_bits
            while (db > self.final_poly_bits
                   and db + rate_bits - self.arity_bits >= cap_height):
                assert db >= self.arity_bits
                result.append(self.arity_bits)
                db -= self.arity_bits
            return tuple(result)
        if self.kind == "min_size":
            return _min_size_arity_bits(degree_bits, rate_bits, num_queries,
                                        self.max_arity_bits)
        raise NotImplementedError(f"FRI reduction strategy {self.kind}")


def _min_size_arity_bits(degree_bits: int, rate_bits: int, num_queries: int,
                         max_arity_bits: Optional[int]) -> tuple[int, ...]:
    """The non-increasing arity sequence of the smallest estimated proof,
    by exhaustive search (reference: reduction_strategies.rs:58-174)."""
    global_max = max_arity_bits or 4

    def relative_proof_size(arity_bits) -> int:
        d = 4
        layer_bits = degree_bits + rate_bits
        total = 0
        for ab in arity_bits:
            total += ((1 << ab) - 1) * d * num_queries
            total += layer_bits * 4 * num_queries
            layer_bits -= ab
        assert layer_bits >= rate_bits
        return total + d * (1 << (layer_bits - rate_bits))

    def best_from(prefix: list) -> tuple:
        layer_bits = degree_bits + rate_bits - sum(prefix)
        best = (tuple(prefix), relative_proof_size(prefix))
        top = min(prefix[-1] if prefix else global_max,
                  layer_bits - rate_bits)
        for next_ab in range(1, top + 1):
            cand = best_from(prefix + [next_ab])
            if cand[1] < best[1]:
                best = cand
        return best

    return best_from([])[0]


@dataclasses.dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    reduction_strategy: FriReductionStrategy = FriReductionStrategy()
    num_query_rounds: int = 28

    def fri_params(self, degree_bits: int, hiding: bool = False) -> "FriParams":
        rab = self.reduction_strategy.reduction_arity_bits(
            degree_bits, self.rate_bits, self.cap_height,
            self.num_query_rounds)
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
    def max_arity_bits(self) -> int:
        return max(self.reduction_arity_bits, default=0)

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
