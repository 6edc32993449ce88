"""The Poseidon GenericConfig (reference: plonk/config.rs:115-208): the
hasher that builds Merkle trees and drives the challenger, and the inner
hasher that hashes public inputs. Host digests are tuples of 4 ints."""

from __future__ import annotations

import dataclasses

from plonky2_tpu.field import reference as ref

from . import poseidon as ps


class PoseidonHasher:
    name = "poseidon"
    hash_size = 32
    digest_width = 4
    algebraic = True

    permute_oracle = staticmethod(ps.permute_host)

    @staticmethod
    def hash_no_pad_oracle(inputs) -> tuple:
        return tuple(ps.hash_no_pad_host(list(inputs)))

    def hash_pad_oracle(self, inputs) -> tuple:
        """pad10*1 then hash (reference: config.rs:62-71; rate 8)."""
        padded = list(inputs) + [1]
        while (len(padded) + 1) % ps.SPONGE_RATE:
            padded.append(0)
        return self.hash_no_pad_oracle(padded + [1])

    @staticmethod
    def hash_or_noop_oracle(inputs) -> tuple:
        return tuple(ps.hash_or_noop_host([int(x) for x in inputs]))

    @staticmethod
    def two_to_one_oracle(left, right) -> tuple:
        return tuple(ps.compress_host(list(left), list(right)))

    @staticmethod
    def digest_from_row(row) -> tuple:
        return tuple(int(x) % ref.ORDER for x in row)


@dataclasses.dataclass(frozen=True)
class GenericConfig:
    name: str
    hasher: PoseidonHasher
    inner_hasher: PoseidonHasher

    def hash_public_inputs(self, inputs: list[int]) -> list[int]:
        """InnerHasher::hash_public_inputs (reference: prover.rs:147)."""
        return list(self.inner_hasher.hash_no_pad_oracle(inputs))


POSEIDON = PoseidonHasher()
PoseidonGoldilocksConfig = GenericConfig("PoseidonGoldilocksConfig",
                                         POSEIDON, POSEIDON)
