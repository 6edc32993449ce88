"""The ported GenericConfigs (reference: plonk/config.rs:115-208):

  PoseidonGoldilocksConfig       Hasher=Poseidon      InnerHasher=Poseidon
  Poseidon2GoldilocksConfig      Hasher=Poseidon2     InnerHasher=Poseidon2

The hasher builds the Merkle trees and drives the challenger; the inner
hasher hashes the public inputs. Each hasher carries its host oracles
(python ints; host digests are tuples of 4 ints) and its device functions
(`permute`, `hash_or_noop_columns`, `hash_or_noop`, `merkle_layers` on
int64 tensors, each a kernel for a CUDA tensor), so callers dispatch on the
hasher, never on a module. `permute_oracle` permutes one state of python
ints and `permute_many_host` a uint64 [n, 12] batch on the host.
"""

from __future__ import annotations

import dataclasses

from ..field import reference as ref
from . import poseidon as ps
from . import poseidon2 as ps2
from .sponge import NUM_HASH_OUT_ELTS, SPONGE_RATE, W


class Hasher:
    """Host oracles shared by the width-12 sponge hashers; a subclass sets
    `permute_oracle` and the device functions."""

    name = ""

    def hash_no_pad_oracle(self, inputs) -> tuple:
        """Overwrite-mode sponge, 4 outputs (reference: hashing.rs:35-64)."""
        state = [0] * W
        for start in range(0, len(inputs), SPONGE_RATE):
            chunk = [int(x) % ref.ORDER
                     for x in inputs[start:start + SPONGE_RATE]]
            state[:len(chunk)] = chunk
            state = self.permute_oracle(state)
        return tuple(state[:NUM_HASH_OUT_ELTS])

    def hash_pad_oracle(self, inputs) -> tuple:
        """pad10*1 then hash (reference: config.rs:62-71; rate 8)."""
        padded = list(inputs) + [1]
        while (len(padded) + 1) % SPONGE_RATE:
            padded.append(0)
        return self.hash_no_pad_oracle(padded + [1])

    def hash_or_noop_oracle(self, inputs) -> tuple:
        """reference: config.rs:74-88 — at most 4 elements pack as the
        digest."""
        if len(inputs) <= NUM_HASH_OUT_ELTS:
            return tuple([int(x) % ref.ORDER for x in inputs]
                         + [0] * (NUM_HASH_OUT_ELTS - len(inputs)))
        return self.hash_no_pad_oracle(inputs)

    def two_to_one_oracle(self, left, right) -> tuple:
        """hash_no_pad(left + right): one permutation of [left, right, 0]."""
        return self.hash_no_pad_oracle(list(left) + list(right))

    @staticmethod
    def digest_from_row(row) -> tuple:
        return tuple(int(x) % ref.ORDER for x in row)


class PoseidonHasher(Hasher):
    name = "poseidon"
    permute_oracle = staticmethod(ps.permute_host)
    permute_many_host = staticmethod(ps.permute_many_host)
    permute = staticmethod(ps.permute)
    hash_or_noop_columns = staticmethod(ps.hash_or_noop_columns)
    hash_or_noop = staticmethod(ps.hash_or_noop)
    merkle_layers = staticmethod(ps.merkle_layers)


class Poseidon2Hasher(Hasher):
    """okx Poseidon2 (reference: hash/poseidon2.rs:599-637)."""
    name = "poseidon2"
    permute_oracle = staticmethod(ps2.permute_host)
    permute_many_host = staticmethod(ps2.permute_many_host)
    permute = staticmethod(ps2.permute)
    hash_or_noop_columns = staticmethod(ps2.hash_or_noop_columns)
    hash_or_noop = staticmethod(ps2.hash_or_noop)
    merkle_layers = staticmethod(ps2.merkle_layers)


POSEIDON = PoseidonHasher()
POSEIDON2 = Poseidon2Hasher()


@dataclasses.dataclass(frozen=True)
class GenericConfig:
    name: str
    hasher: Hasher
    inner_hasher: Hasher

    def hash_public_inputs(self, inputs: list[int]) -> list[int]:
        """InnerHasher::hash_public_inputs (reference: prover.rs:147). It
        must equal the builder's in-circuit public-input hash, which is a
        chain of PoseidonGates, so every inner hasher delegates to Poseidon
        (reference: poseidon_bn128.rs:162-197; the Poseidon2 gadget is
        todo!() upstream, poseidon2.rs:640-662)."""
        return list(POSEIDON.hash_no_pad_oracle(inputs))


PoseidonGoldilocksConfig = GenericConfig("PoseidonGoldilocksConfig",
                                         POSEIDON, POSEIDON)
Poseidon2GoldilocksConfig = GenericConfig("Poseidon2GoldilocksConfig",
                                          POSEIDON2, POSEIDON2)

CONFIGS = {c.name: c for c in (PoseidonGoldilocksConfig,
                               Poseidon2GoldilocksConfig)}
