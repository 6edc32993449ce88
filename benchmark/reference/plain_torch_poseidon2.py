"""Poseidon2 and its Merkle caps in plain PyTorch, for the reference's own
commitment of a circuit's constants and sigmas under
Poseidon2GoldilocksConfig: the field arithmetic and the coset LDE of
`plain_torch.py`, and the permutation of `poseidon2.py` on lanes [12, N],
its layers written as the same dense matrix products (M_E of small
constants through `plain_torch.mat_small`; M_I = J + diag(MATRIX_DIAG_12),
whose diagonal entries are full field elements, as 144 field multiplies
and a sum over each row).
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain_torch as pt
from . import poseidon2 as ps2


def _tables(device):
    """The round constants [30, 12, 1], M_E [12, 12, 1] and M_I
    [12, 12, 1]."""
    rc = pt.from_u64(np.asarray(ps2.RC12, dtype=np.uint64).reshape(
        ps2.ROUNDS, ps2.WIDTH, 1), device)
    external = torch.as_tensor(np.asarray(ps2.EXTERNAL, dtype=np.int64),
                               device=device).reshape(ps2.WIDTH, ps2.WIDTH, 1)
    internal = pt.from_u64(np.asarray(ps2.INTERNAL, dtype=np.uint64),
                           device).reshape(ps2.WIDTH, ps2.WIDTH, 1)
    return rc, external, internal


def _x7(x):
    x2 = pt.mul(x, x)
    return pt.mul(pt.mul(pt.mul(x2, x2), x2), x)


def _dense(m, s):
    """m [12, 12, 1] of field elements times lanes s [12, N]: each row's 12
    products summed by their 32-bit halves, then reduced."""
    lo, hi = pt._split(pt.mul(m, s.unsqueeze(0)))         # [12, 12, N]
    return pt._reduce(lo.sum(1), hi.sum(1))


def permute_lanes(s: torch.Tensor, tables) -> torch.Tensor:
    """The permutation of poseidon2.py on states [12, N]."""
    rc, external, internal = tables
    s = pt.mat_small(external, s)
    for r in range(ps2.ROUNDS):
        s = pt.add(s, rc[r])
        if r in ps2.FULL_ROUNDS:
            s = pt.mat_small(external, _x7(s))
        else:
            s = _dense(internal, torch.cat([_x7(s[:1]), s[1:]]))
    return s


def hash_columns(x: torch.Tensor, tables) -> torch.Tensor:
    """hash_or_noop of each column of x [L, N] -> digests [4, N]."""
    L, n = x.shape
    if L <= 4:
        return torch.cat([x, torch.zeros((4 - L, n), dtype=torch.int64,
                                         device=x.device)])
    s = torch.zeros((ps2.WIDTH, n), dtype=torch.int64, device=x.device)
    for start in range(0, L, ps2.RATE):
        chunk = x[start:start + ps2.RATE]
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
    return [tuple(int(v) for v in col) for col in pt.to_u64(layer).T]


def commitment_cap(values: np.ndarray, rate_bits: int, cap_height: int,
                   device) -> list[tuple]:
    """The Merkle cap of the coset LDE of the polynomials whose values on
    the subgroup are values [k, n]: leaf j holds every polynomial at the
    point of bit-reversed index j."""
    lde = pt.coset_lde(pt.from_u64(values, device), rate_bits)
    n = lde.shape[1]
    leaves = lde[:, torch.as_tensor(pt._bit_reverse_perm(n), device=device)]
    del lde
    return merkle_cap(leaves, cap_height)
