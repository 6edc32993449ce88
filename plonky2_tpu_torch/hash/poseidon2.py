"""Poseidon2 width-12 over Goldilocks: host oracles and batched device
functions (reference: plonky2/src/hash/poseidon2.rs — apply_m_4:329-345,
matmul_internal:395-405, poseidon2:448-476).

The schedule: the initial external layer, 4 full rounds, 22 internal rounds
(round constant and S-box on s[0] only, then the internal layer), 4 full
rounds. A full round adds RC12[r], applies x^7 to every element and then the
external layer: three 4x4 M4 blocks plus the broadcast sum of the blocks.
The internal layer is s[i] * MATRIX_DIAG_12[i] + sum(s).

Host side, on python ints: `permute_host` and `permute_many_host` run the C
permutation of `host.py`, or `poseidon2_oracle` without a C compiler; the
challenger and a CPU prover's PoW grind use these (the sponge over them is
`hashers.Hasher`).

Device side, on int64 tensors:
- `permute(states [B, 12])` is kernel K6 (`csrc/poseidon2.cu`) for a CUDA
  tensor and `permute_plain` for a CPU one;
- `hash_leaves(x [L, N])` is kernel K7, hash_no_pad over each column, for a
  CUDA tensor and `hash_leaves_plain` for a CPU one;
- `merkle_layers(leaf_digests [N, 4], cap_height)` is K6's tree kernel,
  every layer above the leaves in at most two launches, for a CUDA tensor
  and `merkle_layers_plain` (the per-level loop of compress over the plain
  permutation, into the kernel's buffer at its offsets) for a CPU one;
- `hash_or_noop_columns`, `hash_or_noop` and `compress` are built on the
  first two (`sponge.py`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import host
from ..field import goldilocks as gl
from ..field import reference as ref
from . import sponge
from .poseidon2_constants import MATRIX_DIAG_12, RC12, ROUNDS_F, ROUNDS_P
from .sponge import W

HALF_F = ROUNDS_F // 2
# apply_m_4 as a matrix: [t6, t5, t7, t4] of poseidon2.rs:329-345
M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))


def external_matrix() -> list[list[int]]:
    """The external layer as one small-constant 12 x 12 matrix: 2 * M4 on
    the diagonal blocks, M4 off them (the three M4 blocks plus the
    broadcast sum of the blocks)."""
    return [[(2 if r // 4 == c // 4 else 1) * M4[r % 4][c % 4]
             for c in range(W)] for r in range(W)]


# ---------------------------------------------------------------------------
# Host oracles (python ints)
# ---------------------------------------------------------------------------

def _apply_m4(x: list[int]) -> list[int]:
    t0 = (x[0] + x[1]) % ref.ORDER
    t1 = (x[2] + x[3]) % ref.ORDER
    t2 = (2 * x[1] + t1) % ref.ORDER
    t3 = (2 * x[3] + t0) % ref.ORDER
    t4 = (4 * t1 + t3) % ref.ORDER
    t5 = (4 * t0 + t2) % ref.ORDER
    t6 = (t3 + t5) % ref.ORDER
    t7 = (t2 + t4) % ref.ORDER
    return [t6, t5, t7, t4]


def _external_layer(state: list[int]) -> list[int]:
    s = list(state)
    for i in range(0, W, 4):
        s[i:i + 4] = _apply_m4(s[i:i + 4])
    sums = [sum(s[j + k] for j in range(0, W, 4)) % ref.ORDER
            for k in range(4)]
    return [(s[i] + sums[i % 4]) % ref.ORDER for i in range(W)]


def _internal_layer(state: list[int]) -> list[int]:
    total = sum(state) % ref.ORDER
    return [(x * MATRIX_DIAG_12[i] + total) % ref.ORDER
            for i, x in enumerate(state)]


def _sbox_int(x: int) -> int:
    return pow(x, 7, ref.ORDER)


def _full_round_int(s: list[int], r: int) -> list[int]:
    return _external_layer([_sbox_int((x + RC12[r][i]) % ref.ORDER)
                            for i, x in enumerate(s)])


def poseidon2_oracle(state: list[int]) -> list[int]:
    s = _external_layer([int(x) % ref.ORDER for x in state])
    for r in range(HALF_F):
        s = _full_round_int(s, r)
    for r in range(HALF_F, HALF_F + ROUNDS_P):
        s[0] = _sbox_int((s[0] + RC12[r][0]) % ref.ORDER)
        s = _internal_layer(s)
    for r in range(HALF_F + ROUNDS_P, ROUNDS_F + ROUNDS_P):
        s = _full_round_int(s, r)
    return s


def permute_host(state: list[int]) -> list[int]:
    state = [int(x) % ref.ORDER for x in state]
    out = host.permute("poseidon2_permute", state)
    return out if out is not None else poseidon2_oracle(state)


def permute_many_host(states: np.ndarray) -> np.ndarray:
    """uint64 [n, 12] -> permuted [n, 12] on the host."""
    out = host.permute_many("poseidon2_permute", states)
    if out is None:
        out = np.asarray([poseidon2_oracle(list(map(int, s)))
                          for s in states], dtype=np.uint64)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch permutation, state as [12, B] lanes
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _tables(device):
    """The external matrix, the round constants and the internal layer's
    diagonal."""
    ext = np.array(external_matrix(), dtype=np.int64)
    t = lambda a: gl.from_u64(np.asarray(a, dtype=np.uint64), device)
    return dict(
        ext=torch.as_tensor(ext, device=device).reshape(W, W, 1),
        rc=t(RC12).reshape(ROUNDS_F + ROUNDS_P, W, 1),
        partial_rc=t([RC12[HALF_F + r][0] for r in range(ROUNDS_P)]),
        diag=t(MATRIX_DIAG_12).reshape(W, 1),
    )


def _sbox(x):
    x2 = gl.square(x)
    return gl.mul(gl.mul(x2, x), gl.square(x2))


def permute_lanes_plain(s: torch.Tensor) -> torch.Tensor:
    """The permutation on lanes-layout states [12, B]."""
    t = _tables(s.device)
    full = lambda s, r: gl.mat_small(t["ext"], _sbox(gl.add(s, t["rc"][r])))
    s = gl.mat_small(t["ext"], s)
    for r in range(HALF_F):
        s = full(s, r)
    for r in range(ROUNDS_P):
        s0 = _sbox(gl.add(s[0], t["partial_rc"][r]))
        s = torch.cat([s0.unsqueeze(0), s[1:]])
        s = gl.add(gl.mul(s, t["diag"]), gl.reduce_sum(s, 0))
    for r in range(HALF_F + ROUNDS_P, ROUNDS_F + ROUNDS_P):
        s = full(s, r)
    return s


def permute_plain(states: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: [B, 12] -> [B, 12]."""
    return permute_lanes_plain(states.t()).t().contiguous()


def hash_leaves_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: hash_no_pad over each column of
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
    """K6 wrapper: states [B, 12] -> permuted [B, 12]."""
    return sponge.launch_permute("poseidon2_permute", states, permute_plain)


def hash_leaves(x: torch.Tensor) -> torch.Tensor:
    """K7 wrapper: hash_no_pad over each column of x [L, N] -> [N, 4]."""
    return sponge.launch_hash_leaves("poseidon2_hash_leaves", x,
                                     hash_leaves_plain)


def hash_or_noop_columns(x: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over each column of x [L, N] -> digests [N, 4]."""
    return sponge.hash_or_noop_columns(x, hash_leaves)


def hash_or_noop(rows: torch.Tensor) -> torch.Tensor:
    """hash_or_noop over each row of rows [N, L] -> digests [N, 4]."""
    return hash_or_noop_columns(rows.t())


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Two-to-one over digest pairs [m, 4] x [m, 4] -> [m, 4]; equals the
    host two_to_one = hash_no_pad(left + right)."""
    return sponge.compress(left, right, permute)


def merkle_layers(leaf_digests: torch.Tensor, cap_height: int) -> list:
    """K6 tree wrapper: the layers above [N, 4] leaf digests down to the cap
    (layer 1 first, the cap last), as views into one tree buffer."""
    return sponge.launch_merkle_tree("poseidon2_merkle_tree", leaf_digests,
                                     cap_height, merkle_layers_plain)
