"""Poseidon width-12 over Goldilocks: batched device functions and host
oracles.

Device side, on int64 tensors:
- `permute(states [B, 12])` is kernel K2 (`csrc/poseidon.cu`) for a CUDA
  tensor and `permute_plain` for a CPU one;
- `hash_leaves(x [L, N])` is kernel K3, the overwrite-mode sponge
  hash_no_pad over each column, for a CUDA tensor and `hash_leaves_plain`
  for a CPU one;
- `hash_or_noop` and `compress` are built on those two.

The plain versions follow the fast-partial-round schedule of
plonky2_tpu/hash/poseidon_fast.py with the state as [12, B] lanes.

Host side, on python ints (`*_host`): the native C permutation of
plonky2_tpu.native, or poseidon_fast's python-int algebra without a C
compiler; the challenger and the builder use these.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from plonky2_tpu import native
from plonky2_tpu.field import reference as ref
from plonky2_tpu.hash import poseidon_fast as pf
from plonky2_tpu.hash.poseidon_constants import (
    ALL_ROUND_CONSTANTS, HALF_N_FULL_ROUNDS, MDS_MATRIX_CIRC, MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS, N_ROUNDS, SPONGE_RATE, SPONGE_WIDTH,
)

from .. import backend
from ..field import goldilocks as gl

NUM_HASH_OUT_ELTS = 4
W = SPONGE_WIDTH


# ---------------------------------------------------------------------------
# Host oracles (python ints)
# ---------------------------------------------------------------------------

def permute_host(state: list[int]) -> list[int]:
    state = [int(x) % ref.ORDER for x in state]
    out = native.permute(state)
    return out if out is not None else pf.poseidon_fast(pf.INT, state)


def hash_no_pad_host(inputs: list[int]) -> list[int]:
    """Overwrite-mode sponge, 4 outputs (reference: hash/hashing.rs:35-64)."""
    state = [0] * W
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = [int(x) % ref.ORDER for x in inputs[start:start + SPONGE_RATE]]
        state[:len(chunk)] = chunk
        state = permute_host(state)
    return state[:NUM_HASH_OUT_ELTS]


def hash_or_noop_host(inputs: list[int]) -> list[int]:
    if len(inputs) <= NUM_HASH_OUT_ELTS:
        return ([int(x) % ref.ORDER for x in inputs]
                + [0] * (NUM_HASH_OUT_ELTS - len(inputs)))
    return hash_no_pad_host(inputs)


def compress_host(x: list[int], y: list[int]) -> list[int]:
    return permute_host(list(x) + list(y) + [0] * (W - 8))[:NUM_HASH_OUT_ELTS]


# ---------------------------------------------------------------------------
# Plain PyTorch permutation, state as [12, B] lanes
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _tables(device):
    first_rc, partial_rc, vs, w_hats, init_mat = pf.fast_partial_tables()
    t = lambda a: gl.from_u64(np.asarray(a, dtype=np.uint64), device)
    mds = np.array([[MDS_MATRIX_CIRC[(c - r) % W] for c in range(W)]
                    for r in range(W)], dtype=np.int64)
    mds[np.arange(W), np.arange(W)] += np.asarray(MDS_MATRIX_DIAG)
    return dict(
        rc=t(ALL_ROUND_CONSTANTS).reshape(N_ROUNDS, W, 1),
        mds=torch.as_tensor(mds, device=device).reshape(W, W, 1),
        first_rc=t(first_rc).reshape(W, 1),
        partial_rc=t(partial_rc),
        vs=t(vs).reshape(N_PARTIAL_ROUNDS, W - 1, 1),
        w_hats=t(w_hats).reshape(N_PARTIAL_ROUNDS, W - 1, 1),
        init=t(init_mat).reshape(W - 1, W - 1, 1),
    )


def _sbox(x):
    x3 = gl.mul(gl.square(x), x)
    return gl.mul(gl.square(x3), x)


def _mds(s, mds):
    """Small-constant MDS on [12, B]: 32-bit half sums, one reduction."""
    lo, hi = s & gl.M32, (s >> 32) & gl.M32
    return gl._reduce_lh((mds * lo.unsqueeze(0)).sum(1),
                         (mds * hi.unsqueeze(0)).sum(1))


def permute_lanes_plain(s: torch.Tensor) -> torch.Tensor:
    """The permutation on lanes-layout states [12, B]."""
    t = _tables(s.device)
    for r in range(HALF_N_FULL_ROUNDS):
        s = _mds(_sbox(gl.add(s, t["rc"][r])), t["mds"])
    s = gl.add(s, t["first_rc"])
    rest = gl.reduce_sum(gl.mul(t["init"], s[1:].unsqueeze(1)), 0)
    s0 = s[0]
    m00 = MDS_MATRIX_CIRC[0] + MDS_MATRIX_DIAG[0]
    for r in range(N_PARTIAL_ROUNDS):
        s0 = gl.add(_sbox(s0), t["partial_rc"][r])
        d = gl.add(gl.mul_small(s0, m00),
                   gl.reduce_sum(gl.mul(rest, t["w_hats"][r]), 0))
        rest = gl.add(rest, gl.mul(s0, t["vs"][r]))
        s0 = d
    s = torch.cat([s0.unsqueeze(0), rest])
    for r in range(N_ROUNDS - HALF_N_FULL_ROUNDS, N_ROUNDS):
        s = _mds(_sbox(gl.add(s, t["rc"][r])), t["mds"])
    return s


def permute_plain(states: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: [B, 12] -> [B, 12]."""
    return permute_lanes_plain(states.t()).t().contiguous()


def hash_leaves_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: hash_no_pad over each column of
    x [L, N] -> digests [N, 4]."""
    L, n = x.shape
    s = torch.zeros((W, n), dtype=torch.int64, device=x.device)
    for start in range(0, L, SPONGE_RATE):
        chunk = x[start:start + SPONGE_RATE]
        s = permute_lanes_plain(torch.cat([chunk, s[chunk.shape[0]:]]))
    return s[:NUM_HASH_OUT_ELTS].t().contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def permute(states: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: states [B, 12] -> permuted [B, 12]."""
    if states.ndim != 2 or states.shape[1] != W:
        raise ValueError(f"poseidon_permute: states must be [B, 12], got "
                         f"{tuple(states.shape)}")
    if backend.plain_path(states, "poseidon_permute"):
        return permute_plain(states)
    states = states.contiguous()
    backend.require_cuda_int64(states, "poseidon_permute")
    out = torch.empty_like(states)
    n = states.shape[0]
    rc = backend.lib().poseidon_permute(states.data_ptr(), out.data_ptr(), n,
                                        backend.stream(states))
    backend.check(rc, "poseidon_permute")
    backend.KERNELS["poseidon_permute"].launched((n,))
    return out


def hash_leaves(x: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: hash_no_pad over each column of x [L, N] -> [N, 4]."""
    if x.ndim != 2 or x.shape[0] <= NUM_HASH_OUT_ELTS:
        raise ValueError(f"poseidon_hash_leaves: x must be [L > 4, N], got "
                         f"{tuple(x.shape)}")
    if backend.plain_path(x, "poseidon_hash_leaves"):
        return hash_leaves_plain(x)
    x = x.contiguous()
    backend.require_cuda_int64(x, "poseidon_hash_leaves")
    L, n = x.shape
    out = torch.empty((n, NUM_HASH_OUT_ELTS), dtype=torch.int64,
                      device=x.device)
    rc = backend.lib().poseidon_hash_leaves(x.data_ptr(), out.data_ptr(), L,
                                            n, backend.stream(x))
    backend.check(rc, "poseidon_hash_leaves")
    backend.KERNELS["poseidon_hash_leaves"].launched((L, n))
    return out


def hash_or_noop_columns(x: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over each column of x [L, N] -> digests [N, 4]."""
    L, n = x.shape
    if L <= NUM_HASH_OUT_ELTS:
        pad = torch.zeros((NUM_HASH_OUT_ELTS - L, n), dtype=torch.int64,
                          device=x.device)
        return torch.cat([x, pad]).t().contiguous()
    return hash_leaves(x)


def hash_or_noop(rows: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over each row of rows [N, L] -> digests [N, 4]."""
    return hash_or_noop_columns(rows.t())


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one over digest pairs [m, 4] x [m, 4] -> [m, 4]."""
    zeros = torch.zeros_like(left)
    return permute(torch.cat([left, right, zeros], dim=1))[:, :4]
