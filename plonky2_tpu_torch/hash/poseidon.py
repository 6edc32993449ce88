"""Poseidon width-12 over Goldilocks: batched device functions and host
oracles.

Device side, on int64 tensors:
- `permute(states [B, 12])` is kernel K2 (`csrc/poseidon.cu`) for a CUDA
  tensor and `permute_plain` for a CPU one;
- `hash_leaves(x [L, N])` is kernel K3, the overwrite-mode sponge
  hash_no_pad over each column, for a CUDA tensor and `hash_leaves_plain`
  for a CPU one;
- `merkle_layers(leaf_digests [N, 4], cap_height)` is K2's tree kernel,
  every layer above the leaves in at most two launches, for a CUDA tensor
  and `merkle_layers_plain` for a CPU one;
- `hash_or_noop_columns`, `hash_or_noop` and `compress` are built on the
  first two (`sponge.py`).

The plain versions follow the fast-partial-round schedule of
`poseidon_fast.py` with the state as [12, B] lanes; the plain tree is the
per-level loop of compress over the plain permutation, into the kernel's
buffer at its offsets.

Host side, on python ints: `permute_host` and `permute_many_host` run the C
permutation of `host.py`, or poseidon_fast's python-int algebra without a C
compiler; the challenger, the builder and a CPU prover's PoW grind use
these (the sponge over them is `hashers.Hasher`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import host
from ..field import goldilocks as gl
from ..field import reference as ref
from . import poseidon_fast as pf
from . import sponge
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS, HALF_N_FULL_ROUNDS, MDS_MATRIX_CIRC, MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS, N_ROUNDS,
)
from .sponge import W


# ---------------------------------------------------------------------------
# Host oracles (python ints)
# ---------------------------------------------------------------------------

def permute_host(state: list[int]) -> list[int]:
    state = [int(x) % ref.ORDER for x in state]
    out = host.permute("poseidon_permute", state)
    return out if out is not None else pf.poseidon_fast(pf.INT, state)


def permute_many_host(states: np.ndarray) -> np.ndarray:
    """uint64 [n, 12] -> permuted [n, 12] on the host."""
    out = host.permute_many("poseidon_permute", states)
    if out is None:
        out = np.asarray([permute_host(list(map(int, s))) for s in states],
                         dtype=np.uint64)
    return out


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


def _full_round(s, t, r):
    """Round constants, S-boxes and the MDS layer of full round r."""
    return gl.mat_small(t["mds"], _sbox(gl.add(s, t["rc"][r])))


def permute_lanes_plain(s: torch.Tensor) -> torch.Tensor:
    """The permutation on lanes-layout states [12, B]."""
    t = _tables(s.device)
    for r in range(HALF_N_FULL_ROUNDS):
        s = _full_round(s, t, r)
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
        s = _full_round(s, t, r)
    return s


def permute_plain(states: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: [B, 12] -> [B, 12]."""
    return permute_lanes_plain(states.t()).t().contiguous()


def hash_leaves_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: hash_no_pad over each column of
    x [L, N] -> digests [N, 4]."""
    return sponge.hash_leaves_plain(x, permute_lanes_plain)


def merkle_layers_plain(leaf_digests: torch.Tensor,
                        cap_height: int) -> list:
    """Plain PyTorch version of the tree kernel: the layers above [N, 4]
    leaf digests down to the cap, as views into one tree buffer."""
    return sponge.merkle_layers_by_level(
        leaf_digests, cap_height,
        lambda left, right: sponge.compress(left, right, permute_plain))


# ---------------------------------------------------------------------------
# Kernel wrappers and the functions built on them
# ---------------------------------------------------------------------------

def permute(states: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: states [B, 12] -> permuted [B, 12]."""
    return sponge.launch_permute("poseidon_permute", states, permute_plain)


def hash_leaves(x: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: hash_no_pad over each column of x [L, N] -> [N, 4]."""
    return sponge.launch_hash_leaves("poseidon_hash_leaves", x,
                                     hash_leaves_plain)


def merkle_layers(leaf_digests: torch.Tensor, cap_height: int) -> list:
    """K2 tree wrapper: the layers above [N, 4] leaf digests down to the cap
    (layer 1 first, the cap last), as views into one tree buffer."""
    return sponge.launch_merkle_tree("poseidon_merkle_tree", leaf_digests,
                                     cap_height, merkle_layers_plain)


def hash_or_noop_columns(x: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over each column of x [L, N] -> digests [N, 4]."""
    return sponge.hash_or_noop_columns(x, hash_leaves)


def hash_or_noop(rows: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over each row of rows [N, L] -> digests [N, 4]."""
    return hash_or_noop_columns(rows.t())


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one over digest pairs [m, 4] x [m, 4] -> [m, 4]."""
    return sponge.compress(left, right, permute)
