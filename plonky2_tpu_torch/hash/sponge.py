"""The width-12 overwrite sponge shared by Poseidon and Poseidon2 (rate 8,
4-element digests; reference: hash/hashing.rs:35-64, plonk/config.rs:74-88).

Each permutation module (`poseidon.py`, `poseidon2.py`) owns a permutation
kernel, a fused leaf-sponge kernel and a Merkle tree kernel (the kernels of
`csrc/sponge_kernels.cuh` on its permutation) with their plain versions;
the functions here launch a kernel through its wrapper contract (a CPU
tensor takes the plain version, a CUDA tensor the kernel, anything else
raises) and build hash_or_noop and compress on top of them.

A tree's layers above its n leaves live in one [n - 2^cap_height, 4] buffer,
layer l (1 for the leaves' parents) at row n - n / 2^(l-1) (`tree_offsets`):
each tree kernel writes it in at most two launches, and the plain version,
`merkle_layers_by_level`, fills the same buffer one compress per level.
"""

from __future__ import annotations

import ctypes

import torch

from .. import backend
from ..utils.bits import log2_strict

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
    rc = backend.call(name, states, states.data_ptr(), out.data_ptr(), n,
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
    rc = backend.call(name, x, x.data_ptr(), out.data_ptr(), L, n,
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


def tree_offsets(n: int, cap_height: int) -> list[int]:
    """Row of each layer above the n leaves in the tree buffer, layer 1
    first, then the buffer's row count."""
    depth = log2_strict(n) - cap_height
    return [n - (n >> (level - 1)) for level in range(1, depth + 2)]


def _tree_buffer(leaf_digests: torch.Tensor, cap_height: int):
    """An empty tree buffer for the leaf digests, and each layer's rows."""
    offs = tree_offsets(leaf_digests.shape[0], cap_height)
    buf = torch.empty((offs[-1], NUM_HASH_OUT_ELTS), dtype=torch.int64,
                      device=leaf_digests.device)
    return buf, list(zip(offs, offs[1:]))


def merkle_layers_by_level(leaf_digests: torch.Tensor, cap_height: int,
                           compress) -> list:
    """The layers above [n, 4] leaf digests down to the cap, one batched
    compress per level, as views into one tree buffer."""
    buf, spans = _tree_buffer(leaf_digests, cap_height)
    layer = leaf_digests
    for lo, hi in spans:
        pairs = layer.reshape(-1, 2 * NUM_HASH_OUT_ELTS)
        buf[lo:hi] = compress(pairs[:, :NUM_HASH_OUT_ELTS],
                              pairs[:, NUM_HASH_OUT_ELTS:])
        layer = buf[lo:hi]
    return [buf[lo:hi] for lo, hi in spans]


def launch_merkle_tree(name: str, leaf_digests: torch.Tensor,
                       cap_height: int, plain) -> list:
    """Tree kernel `name`: the layers above [n, 4] leaf digests down to the
    cap (n a power of two) as views into one tree buffer, layer 1 first."""
    if leaf_digests.ndim != 2 or leaf_digests.shape[1] != NUM_HASH_OUT_ELTS:
        raise ValueError(f"{name}: leaf digests must be [n, 4], got "
                         f"{tuple(leaf_digests.shape)}")
    n = leaf_digests.shape[0]
    if not 0 <= cap_height <= log2_strict(n):
        raise ValueError(f"{name}: cap height {cap_height} for {n} leaves")
    if backend.plain_path(leaf_digests, name):
        return plain(leaf_digests, cap_height)
    leaf_digests = leaf_digests.contiguous()
    backend.require_cuda_int64(leaf_digests, name)
    buf, spans = _tree_buffer(leaf_digests, cap_height)
    launches = ctypes.c_int(0)
    rc = backend.call(
        name, leaf_digests, leaf_digests.data_ptr(), buf.data_ptr(), n,
        cap_height, backend.stream(leaf_digests), ctypes.byref(launches))
    backend.check(rc, name)
    for _ in range(launches.value):
        backend.KERNELS[name].launched((n, cap_height))
    return [buf[lo:hi] for lo, hi in spans]
