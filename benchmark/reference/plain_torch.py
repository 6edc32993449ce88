"""Goldilocks arithmetic, the NTT, Poseidon and Merkle caps in plain
PyTorch, for the reference's own commitments (a circuit's constants and
sigmas): elementwise int64 operations only, on any device.

A field tensor holds the canonical u64 bit pattern in int64. PyTorch has no
uint64 arithmetic, so values are split into 32-bit halves and products are
formed from 32 x 16-bit pieces, which stay below 2^48; one reduction takes
L + H 2^32 (0 <= L, H < 2^62) to its canonical residue with
2^64 = 2^32 - 1 (mod p).
"""

from __future__ import annotations

import numpy as np
import torch

from . import poseidon as ps
from .field import GENERATOR, P, root_of_unity

M32 = 0xFFFFFFFF
M16 = 0xFFFF


def from_u64(x: np.ndarray, device) -> torch.Tensor:
    x = np.ascontiguousarray(x, dtype=np.uint64)
    if (x >= np.uint64(P)).any():
        raise ValueError("value outside the field")
    return torch.from_numpy(x.view(np.int64).copy()).to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy().view(np.uint64).copy()


def const(c: int, device, shape=()) -> torch.Tensor:
    c %= P
    return torch.full(shape, c - (1 << 64) if c >= 1 << 63 else c,
                      dtype=torch.int64, device=device)


def _split(a):
    return a & M32, (a >> 32) & M32


def _reduce(L, H):
    """(L + H 2^32) mod p for 0 <= L, H < 2^62, canonical."""
    for _ in range(3):
        H = H + (L >> 32)
        L = L & M32
        q = H >> 32
        H = (H & M32) + q
        L = L - q
    H = H + (L >> 32)
    L = L & M32
    over = (H == M32) & (L != 0)
    return torch.where(over, L - 1, (H << 32) | L)


def _mul32(x, y):
    t0 = x * (y & M16)
    t1 = x * (y >> 16)
    lo = (t0 & M32) + ((t1 & M16) << 16)
    hi = (t0 >> 32) + (t1 >> 16) + (lo >> 32)
    return lo & M32, hi


def add(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    return _reduce(a0 + b0, a1 + b1)


def sub(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    return _reduce(a0 - b0 + (2 + (1 << 32)), a1 - b1 + ((1 << 33) - 3))


def mul(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    ll0, ll1 = _mul32(a0, b0)
    lh0, lh1 = _mul32(a0, b1)
    hl0, hl1 = _mul32(a1, b0)
    hh0, hh1 = _mul32(a1, b1)
    c1 = ll1 + lh0 + hl0
    c2 = lh1 + hl1 + hh0
    return _reduce(ll0 - c2 - hh1 + (4 + (1 << 34)), c1 + c2 + ((1 << 34) - 8))


def mat_small(m, s):
    """m [R, C, 1] of constants below 2^20 times lanes s [C, N]."""
    lo, hi = _split(s)
    return _reduce((m * lo.unsqueeze(0)).sum(1), (m * hi.unsqueeze(0)).sum(1))


def powers(base: int, n: int, device) -> torch.Tensor:
    out = [1]
    for _ in range(n - 1):
        out.append(out[-1] * base % P)
    return from_u64(np.asarray(out, dtype=np.uint64), device)


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def dft(x: torch.Tensor, root: int) -> torch.Tensor:
    """Rows x [k, n] -> sum_j x_j root^(ij) for i < n (radix-2, decimation
    in time over bit-reversed input)."""
    k, n = x.shape
    lg = n.bit_length() - 1
    y = x[:, torch.as_tensor(_bit_reverse_perm(n), device=x.device)]
    for s in range(lg):
        m = 1 << s
        w = powers(pow(root, n // (2 * m), P), m, x.device)
        yr = y.reshape(k, n // (2 * m), 2, m)
        u, t = yr[:, :, 0], mul(yr[:, :, 1], w)
        y = torch.stack([add(u, t), sub(u, t)], dim=2).reshape(k, n)
    return y


def coset_lde(values: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """Values [k, n] on the subgroup of order n -> the values of the same
    polynomials at GENERATOR * w^i, i < n 2^rate_bits, natural order."""
    k, n = values.shape
    lg = n.bit_length() - 1
    coeffs = dft(values, pow(root_of_unity(lg), P - 2, P))
    coeffs = mul(coeffs, const(pow(n, P - 2, P), values.device, (1, 1)))
    coeffs = mul(coeffs, powers(GENERATOR, n, values.device))
    padded = torch.zeros((k, n << rate_bits), dtype=torch.int64,
                         device=values.device)
    padded[:, :n] = coeffs
    return dft(padded, root_of_unity(lg + rate_bits))


def _tables(device):
    rc = np.asarray(ps.ROUND_CONSTANTS, dtype=np.uint64).reshape(
        ps.ROUNDS, ps.WIDTH, 1)
    mds = torch.as_tensor(np.asarray(ps.MDS_ROWS, dtype=np.int64),
                          device=device).reshape(ps.WIDTH, ps.WIDTH, 1)
    return from_u64(rc, device), mds


def _x7(x):
    x2 = mul(x, x)
    return mul(mul(mul(x2, x2), x2), x)


def permute_lanes(s: torch.Tensor, tables) -> torch.Tensor:
    """The permutation of poseidon.py on states [12, N]."""
    rc, mds = tables
    full = set(range(ps.HALF_FULL_ROUNDS)) | set(
        range(ps.ROUNDS - ps.HALF_FULL_ROUNDS, ps.ROUNDS))
    for r in range(ps.ROUNDS):
        s = add(s, rc[r])
        if r in full:
            s = _x7(s)
        else:
            s = torch.cat([_x7(s[:1]), s[1:]])
        s = mat_small(mds, s)
    return s


def hash_columns(x: torch.Tensor, tables) -> torch.Tensor:
    """hash_or_noop of each column of x [L, N] -> digests [4, N]."""
    L, n = x.shape
    if L <= 4:
        return torch.cat([x, torch.zeros((4 - L, n), dtype=torch.int64,
                                         device=x.device)])
    s = torch.zeros((ps.WIDTH, n), dtype=torch.int64, device=x.device)
    for start in range(0, L, ps.RATE):
        chunk = x[start:start + ps.RATE]
        s = permute_lanes(torch.cat([chunk, s[chunk.shape[0]:]]), tables)
    return s[:4]


def merkle_cap(leaves: torch.Tensor, cap_height: int) -> list[tuple]:
    """The cap of the tree over the columns of leaves [L, N] (leaf i is
    column i): 2^cap_height digests."""
    tables = _tables(leaves.device)
    layer = hash_columns(leaves, tables)                  # [4, N]
    while layer.shape[1] > 1 << cap_height:
        pairs = layer.reshape(4, -1, 2)
        state = torch.cat([pairs[:, :, 0], pairs[:, :, 1],
                           torch.zeros_like(pairs[:, :, 0])])
        layer = permute_lanes(state, tables)[:4]
    return [tuple(int(v) for v in col) for col in to_u64(layer).T]


def commitment_cap(values: np.ndarray, rate_bits: int, cap_height: int,
                   device) -> list[tuple]:
    """The Merkle cap of the coset LDE of the polynomials whose values on
    the subgroup are values [k, n]: leaf j holds every polynomial at the
    point of bit-reversed index j."""
    lde = coset_lde(from_u64(values, device), rate_bits)
    N = lde.shape[1]
    leaves = lde[:, torch.as_tensor(_bit_reverse_perm(N), device=device)]
    del lde
    return merkle_cap(leaves, cap_height)
