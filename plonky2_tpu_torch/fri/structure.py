"""FRI instance/opening descriptors (reference: plonky2/src/fri/structure.rs)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FriOracleInfo:
    num_polys: int
    blinding: bool


@dataclasses.dataclass(frozen=True)
class FriPolynomialInfo:
    oracle_index: int
    polynomial_index: int

    @staticmethod
    def from_range(oracle_index: int, start: int, stop: int):
        return [FriPolynomialInfo(oracle_index, i) for i in range(start, stop)]


@dataclasses.dataclass(frozen=True)
class FriBatchInfo:
    """Opening point (extension, as an int pair) + polys opened there."""
    point: tuple[int, int]
    polynomials: tuple[FriPolynomialInfo, ...]


@dataclasses.dataclass(frozen=True)
class FriInstanceInfo:
    oracles: tuple[FriOracleInfo, ...]
    batches: tuple[FriBatchInfo, ...]


@dataclasses.dataclass(frozen=True)
class FriOpeningBatch:
    values: tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class FriOpenings:
    batches: tuple[FriOpeningBatch, ...]


@dataclasses.dataclass(frozen=True)
class FriChallenges:
    fri_alpha: tuple[int, int]
    fri_betas: tuple[tuple[int, int], ...]
    fri_pow_response: int
    fri_query_indices: tuple[int, ...]
