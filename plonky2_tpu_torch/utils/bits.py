"""Bit/index utilities (host-side numpy)
(reference: util/src/lib.rs:16-110 — log2_strict, reverse_index_bits).
Permutations are materialized as gather-index arrays once per size."""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def log2_strict(n: int) -> int:
    k = n.bit_length() - 1
    assert 1 << k == n, f"{n} is not a power of two"
    return k


def log2_ceil(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 0


@lru_cache(maxsize=None)
def reverse_index_bits_perm(n: int) -> np.ndarray:
    """Gather indices implementing the bit-reversal permutation of size n."""
    bits = log2_strict(n)
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.astype(np.int32)


def reverse_bits(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


@lru_cache(maxsize=None)
def ifft_reverse_perm(n: int) -> np.ndarray:
    """Indices j -> (n - j) mod n, used to turn a forward FFT into an inverse."""
    return ((n - np.arange(n, dtype=np.int64)) % n).astype(np.int32)
