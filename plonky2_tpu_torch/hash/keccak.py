"""Keccak-256 for the KeccakGoldilocksConfig, on the host.

Reference: plonky2/src/hash/keccak.rs:103-219 (KeccakHash<N>: BytesHash
digests over the LE-byte serialization of field elements; two_to_one =
keccak256(left || right)). Python's hashlib sha3 uses the SHA-3 padding, not
the original Keccak padding (0x01) that keccak256 uses, so keccak-f[1600] is
implemented here directly: `keccak256` on bytes (the oracle), and
`keccak256_np` over a numpy batch of equal-length messages (the Merkle
layers and the PoW grind). Host numpy on uint64: torch on the CPU has no
uint64 shifts.
"""

from __future__ import annotations

import numpy as np

_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_MASK = (1 << 64) - 1
RATE = 136  # bytes: the 1088-bit rate of keccak-256


def _rotl(x, n):
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> list[int]:
    """keccak-f[1600] on 25 lanes, state[x + 5 y] = A[x, y]."""
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        a = [[b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
              for y in range(5)] for x in range(5)]
        # iota
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak256(data: bytes) -> bytes:
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % RATE:
        padded.append(0x00)
    padded[-1] ^= 0x80
    state = [0] * 25
    for off in range(0, len(padded), RATE):
        block = padded[off:off + RATE]
        for i in range(RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = _keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


_RC_NP = np.asarray(_RC, dtype=np.uint64)


def _rotl_np(x: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return x
    return (x << np.uint64(n)) | (x >> np.uint64(64 - n))


def keccak_f_np(state: np.ndarray) -> np.ndarray:
    """keccak-f[1600] over a batch: uint64 [n, 25] in `_keccak_f`'s lane
    order."""
    a = [[state[:, x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC_NP:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl_np(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl_np(a[x][y], _ROT[x][y])
        a = [[b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y])
              for y in range(5)] for x in range(5)]
        a[0][0] = a[0][0] ^ rc
    return np.stack([a[x][y] for y in range(5) for x in range(5)], axis=1)


def keccak256_np(data: np.ndarray) -> np.ndarray:
    """keccak256 of each row: uint8 [n, L] -> uint8 [n, 32]."""
    n, L = data.shape
    padded = np.zeros((n, L + RATE - L % RATE), dtype=np.uint8)
    padded[:, :L] = data
    padded[:, L] = 0x01
    padded[:, -1] ^= 0x80
    lanes = padded.view("<u8").reshape(n, -1, RATE // 8)
    state = np.zeros((n, 25), dtype=np.uint64)
    for block in range(lanes.shape[1]):
        state[:, :RATE // 8] ^= lanes[:, block]
        state = keccak_f_np(state)
    return np.ascontiguousarray(state[:, :4]).astype("<u8").view(np.uint8)


def field_bytes_np(rows: np.ndarray) -> np.ndarray:
    """uint64 [n, L] field elements -> their LE bytes, uint8 [n, 8 L]."""
    return np.ascontiguousarray(rows, dtype=np.uint64).astype("<u8").view(
        np.uint8).reshape(rows.shape[0], -1)
