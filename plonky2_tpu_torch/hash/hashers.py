"""The GenericConfigs (reference: plonk/config.rs:115-208):

  PoseidonGoldilocksConfig       Hasher=Poseidon      InnerHasher=Poseidon
  Poseidon2GoldilocksConfig      Hasher=Poseidon2     InnerHasher=Poseidon2
  KeccakGoldilocksConfig         Hasher=Keccak<25>    InnerHasher=Poseidon
  PoseidonBN128GoldilocksConfig  Hasher=PoseidonBN128 InnerHasher=PoseidonBN128
                                 (whose public-input hash delegates to
                                 Poseidon, poseidon_bn128.rs:162-197)

The hasher builds the Merkle trees and drives the challenger; the inner
hasher hashes the public inputs. Each hasher carries its host oracles
(python ints; a host digest is a tuple of 4 ints, or bytes for Keccak's
25-byte digests) and says by its flags where its trees are built:
- `device` True (Poseidon, Poseidon2): the device functions `permute`,
  `hash_or_noop_columns`, `hash_or_noop` and `merkle_layers` on int64
  tensors, each a kernel for a CUDA tensor; digest layers stay on the
  tensor's device;
- `device` False (Keccak, PoseidonBN128): `hash_leaves_np` and
  `compress_np` on numpy batches, on the host whatever the leaves' device,
  as the reference's outer-proof hashers (they exist for cheap external
  verification, on a chain or in a BN254 circuit).
`algebraic` says whether a digest is 4 field elements; `hash_size` is its
size in bytes and `digest_width` the last dimension of its numpy rows.
`permute_oracle` permutes one state of python ints and `permute_many_host`
a uint64 [n, 12] batch on the host (the challenger and the host PoW grind).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import host
from ..field import reference as ref
from . import keccak as kk
from . import poseidon as ps
from . import poseidon2 as ps2
from . import poseidon_bn128 as bn
from .sponge import NUM_HASH_OUT_ELTS, SPONGE_RATE, W


def digest_to_elements(d) -> list[int]:
    """GenericHashOut::to_vec (reference: hash_types.rs:109-117, :182-192):
    a byte digest as 7-byte LE chunks (25 bytes -> 4 elements)."""
    if isinstance(d, (bytes, bytearray)):
        return [int.from_bytes(d[i:i + 7], "little")
                for i in range(0, len(d), 7)]
    return [int(x) for x in d]


def digest_to_bytes(d) -> bytes:
    """GenericHashOut::to_bytes: a byte digest (bytes, or a uint8 row) as
    is, 4 elements as 32 LE bytes."""
    if isinstance(d, (bytes, bytearray)) or \
            getattr(d, "dtype", None) == np.uint8:
        return bytes(d)
    return b"".join((int(x) % ref.ORDER).to_bytes(8, "little") for x in d)


class Hasher:
    """Host oracles shared by the hashers; the width-12 sponge over
    `permute_oracle` serves the algebraic ones, Keccak overrides it."""

    name = ""
    hash_size = 32           # bytes of a digest
    digest_width = NUM_HASH_OUT_ELTS
    digest_dtype = np.uint64
    algebraic = True         # a digest is 4 field elements
    device = True            # trees built by device kernels

    def hash_no_pad_oracle(self, inputs) -> tuple:
        """Overwrite-mode sponge, 4 outputs (reference: hashing.rs:35-64)."""
        state = [0] * W
        for start in range(0, len(inputs), SPONGE_RATE):
            chunk = [int(x) % ref.ORDER
                     for x in inputs[start:start + SPONGE_RATE]]
            state[:len(chunk)] = chunk
            state = self.permute_oracle(state)
        return tuple(state[:NUM_HASH_OUT_ELTS])

    def hash_pad_oracle(self, inputs):
        """pad10*1 then hash (reference: config.rs:62-71; rate 8)."""
        padded = list(inputs) + [1]
        while (len(padded) + 1) % SPONGE_RATE:
            padded.append(0)
        return self.hash_no_pad_oracle(padded + [1])

    def hash_or_noop_oracle(self, inputs):
        """reference: config.rs:74-88 — inputs that fit in a digest's bytes
        pack as the digest."""
        if len(inputs) * 8 <= self.hash_size:
            raw = b"".join((int(x) % ref.ORDER).to_bytes(8, "little")
                           for x in inputs)
            return self.digest_from_bytes(
                raw + b"\x00" * (self.hash_size - len(raw)))
        return self.hash_no_pad_oracle(inputs)

    def two_to_one_oracle(self, left, right):
        """hash_no_pad(left + right): one permutation of [left, right, 0]."""
        return self.hash_no_pad_oracle(list(left) + list(right))

    def digest_from_bytes(self, b: bytes):
        if self.algebraic:
            return tuple(int.from_bytes(b[8 * i:8 * i + 8], "little")
                         for i in range(NUM_HASH_OUT_ELTS))
        return bytes(b)

    def digest_from_row(self, row):
        """A digest row (numpy, a tuple, bytes) -> the host digest."""
        if self.algebraic:
            return tuple(int(x) % ref.ORDER for x in row)
        return bytes(bytearray(row))


class PoseidonHasher(Hasher):
    name = "poseidon"
    permute_oracle = staticmethod(ps.permute_host)
    permute_many_host = staticmethod(ps.permute_many_host)
    permute = staticmethod(ps.permute)
    hash_or_noop_columns = staticmethod(ps.hash_or_noop_columns)
    hash_or_noop = staticmethod(ps.hash_or_noop)
    compress = staticmethod(ps.compress)
    merkle_layers = staticmethod(ps.merkle_layers)


class Poseidon2Hasher(Hasher):
    """okx Poseidon2 (reference: hash/poseidon2.rs:599-637)."""
    name = "poseidon2"
    permute_oracle = staticmethod(ps2.permute_host)
    permute_many_host = staticmethod(ps2.permute_many_host)
    permute = staticmethod(ps2.permute)
    hash_or_noop_columns = staticmethod(ps2.hash_or_noop_columns)
    hash_or_noop = staticmethod(ps2.hash_or_noop)
    compress = staticmethod(ps2.compress)
    merkle_layers = staticmethod(ps2.merkle_layers)


class KeccakHasher(Hasher):
    """Truncated keccak256 (reference: hash/keccak.rs:103-131, N=25). The
    challenger permutation is the keccak "hash onion" with u64 rejection
    sampling (keccak.rs:63-98)."""
    name = "keccak25"
    hash_size = 25
    digest_width = 25
    digest_dtype = np.uint8
    algebraic = False
    device = False

    @staticmethod
    def permute_oracle(state) -> list[int]:
        """Hash the state's 96 LE bytes, then each 32-byte output again,
        keeping the u64 words below the order until 12 are kept."""
        h = b"".join((int(x) % ref.ORDER).to_bytes(8, "little")
                     for x in state)
        out: list[int] = []
        while len(out) < W:
            h = kk.keccak256(h)
            for i in range(4):
                w = int.from_bytes(h[8 * i:8 * i + 8], "little")
                if w < ref.ORDER and len(out) < W:
                    out.append(w)
        return out

    def hash_no_pad_oracle(self, inputs) -> bytes:
        data = b"".join((int(x) % ref.ORDER).to_bytes(8, "little")
                        for x in inputs)
        return kk.keccak256(data)[:self.hash_size]

    def two_to_one_oracle(self, left, right) -> bytes:
        return kk.keccak256(bytes(left) + bytes(right))[:self.hash_size]

    def hash_leaves_np(self, leaves: np.ndarray) -> np.ndarray:
        """hash_or_noop over uint64 [n, L] rows -> uint8 [n, 25]."""
        n, width = leaves.shape
        data = kk.field_bytes_np(leaves)
        if width * 8 <= self.hash_size:
            out = np.zeros((n, self.hash_size), dtype=np.uint8)
            out[:, :width * 8] = data
            return out
        return kk.keccak256_np(data)[:, :self.hash_size]

    def compress_np(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """two_to_one over uint8 [m, 25] pairs."""
        return kk.keccak256_np(np.concatenate([left, right], axis=1))[
            :, :self.hash_size]

    def permute_many_host(self, states: np.ndarray) -> np.ndarray:
        """`permute_oracle` over uint64 [n, 12] (the PoW grind): three
        onion layers give 12 words; a row with a word at or above the order
        (probability about 12 / 2^32) takes the scalar onion, which hashes
        further."""
        layers = [kk.keccak256_np(kk.field_bytes_np(states))]
        for _ in range(2):
            layers.append(kk.keccak256_np(layers[-1]))
        out = np.concatenate([h.view("<u8") for h in layers], axis=1)
        for i in np.nonzero((out >= np.uint64(ref.ORDER)).any(axis=1))[0]:
            out[i] = self.permute_oracle([int(x) for x in states[i]])
        return out


def _bn128_permute(state) -> list[int]:
    state = [int(x) % ref.ORDER for x in state]
    out = host.bn128_permute(state)
    return out if out is not None else bn.permute_bn128(state)


class PoseidonBN128Hasher(Hasher):
    """Poseidon over the BN254 scalar field on the packed 12-u64 state
    (reference: hash/poseidon_bn128.rs; the threaded C library of `host.py`,
    the Python permutation of `poseidon_bn128.py` without a C compiler).
    Its digests are 4 field elements; its trees are built on the host."""
    name = "poseidon_bn128"
    algebraic = True
    device = False

    permute_oracle = staticmethod(_bn128_permute)

    def hash_no_pad_oracle(self, inputs) -> tuple:
        out = host.bn128_hash_no_pad([int(x) % ref.ORDER for x in inputs])
        return out if out is not None else super().hash_no_pad_oracle(inputs)

    def hash_leaves_np(self, leaves: np.ndarray) -> np.ndarray:
        out = host.bn128_hash_leaves(leaves)
        if out is None:
            out = np.asarray([self.hash_or_noop_oracle(list(map(int, row)))
                              for row in leaves], dtype=np.uint64)
        return out

    def compress_np(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        out = host.bn128_compress_many(left, right)
        if out is None:
            out = np.asarray([self.two_to_one_oracle(list(map(int, a)),
                                                     list(map(int, b)))
                              for a, b in zip(left, right)], dtype=np.uint64)
        return out

    def permute_many_host(self, states: np.ndarray) -> np.ndarray:
        out = host.bn128_permute_many(states)
        if out is None:
            out = np.asarray([_bn128_permute(s) for s in states],
                             dtype=np.uint64)
        return out


POSEIDON = PoseidonHasher()
POSEIDON2 = Poseidon2Hasher()
KECCAK = KeccakHasher()
POSEIDON_BN128 = PoseidonBN128Hasher()


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
KeccakGoldilocksConfig = GenericConfig("KeccakGoldilocksConfig",
                                       KECCAK, POSEIDON)
PoseidonBN128GoldilocksConfig = GenericConfig(
    "PoseidonBN128GoldilocksConfig", POSEIDON_BN128, POSEIDON_BN128)

CONFIGS = {c.name: c for c in (
    PoseidonGoldilocksConfig, Poseidon2GoldilocksConfig,
    KeccakGoldilocksConfig, PoseidonBN128GoldilocksConfig)}
