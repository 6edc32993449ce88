"""The width-12 overwrite sponge shared by Poseidon and Poseidon2 (rate 8,
4-element digests; reference: hash/hashing.rs:35-64, plonk/config.rs:74-88).

Each permutation module (`poseidon.py`, `poseidon2.py`) owns a permutation
kernel and a fused leaf-sponge kernel with their plain versions; the
functions here launch a kernel through its wrapper contract (a CPU tensor
takes the plain version, a CUDA tensor the kernel, anything else raises)
and build hash_or_noop and compress on top of the two kernels.
"""

from __future__ import annotations

import torch

from .. import backend

W = 12
SPONGE_RATE = 8
NUM_HASH_OUT_ELTS = 4


def launch_permute(name: str, states: torch.Tensor, plain) -> torch.Tensor:
    """Permutation kernel `name` over states [B, 12] -> [B, 12]."""
    if states.ndim != 2 or states.shape[1] != W:
        raise ValueError(f"{name}: states must be [B, 12], got "
                         f"{tuple(states.shape)}")
    if backend.plain_path(states, name):
        return plain(states)
    states = states.contiguous()
    backend.require_cuda_int64(states, name)
    out = torch.empty_like(states)
    n = states.shape[0]
    rc = getattr(backend.lib(), name)(states.data_ptr(), out.data_ptr(), n,
                                      backend.stream(states))
    backend.check(rc, name)
    backend.KERNELS[name].launched((n,))
    return out


def launch_hash_leaves(name: str, x: torch.Tensor, plain) -> torch.Tensor:
    """Leaf-sponge kernel `name`: hash_no_pad over each column of x [L, N]
    -> digests [N, 4]."""
    if x.ndim != 2 or x.shape[0] <= NUM_HASH_OUT_ELTS:
        raise ValueError(f"{name}: x must be [L > 4, N], got "
                         f"{tuple(x.shape)}")
    if backend.plain_path(x, name):
        return plain(x)
    x = x.contiguous()
    backend.require_cuda_int64(x, name)
    L, n = x.shape
    out = torch.empty((n, NUM_HASH_OUT_ELTS), dtype=torch.int64,
                      device=x.device)
    rc = getattr(backend.lib(), name)(x.data_ptr(), out.data_ptr(), L, n,
                                      backend.stream(x))
    backend.check(rc, name)
    backend.KERNELS[name].launched((L, n))
    return out


def hash_leaves_plain(x: torch.Tensor, permute_lanes) -> torch.Tensor:
    """hash_no_pad over each column of x [L, N] -> [N, 4], with a plain
    permutation on [12, N] lanes."""
    L, n = x.shape
    s = torch.zeros((W, n), dtype=torch.int64, device=x.device)
    for start in range(0, L, SPONGE_RATE):
        chunk = x[start:start + SPONGE_RATE]
        s = permute_lanes(torch.cat([chunk, s[chunk.shape[0]:]]))
    return s[:NUM_HASH_OUT_ELTS].t().contiguous()


def hash_or_noop_columns(x: torch.Tensor, hash_leaves) -> torch.Tensor:
    """hash_or_noop over each column of x [L, N] -> digests [N, 4]: columns
    of at most 4 elements are zero-padded, longer ones hashed."""
    L, n = x.shape
    if L <= NUM_HASH_OUT_ELTS:
        pad = torch.zeros((NUM_HASH_OUT_ELTS - L, n), dtype=torch.int64,
                          device=x.device)
        return torch.cat([x, pad]).t().contiguous()
    return hash_leaves(x)


def compress(left: torch.Tensor, right: torch.Tensor,
             permute) -> torch.Tensor:
    """Two-to-one over digest pairs [m, 4] x [m, 4] -> [m, 4]: the first 4
    elements of the permuted state [left, right, 0, 0, 0, 0]."""
    zeros = torch.zeros_like(left)
    return permute(torch.cat([left, right, zeros], dim=1))[:, :4]
