"""Column-parallel commits over a mesh of ranks (the JAX package's
parallel/sharding.py; reference multi-GPU path fri/oracle.rs:288-301,
hash/merkle_tree.rs:350-438).

A commit of num polynomials over a mesh of D ranks, every rank holding the
whole input (SPMD):
1. rank c takes the polynomials [c b, (c + 1) b), b = ceil(num / D) (the
   last ranks' rows padded with zero polynomials), and runs the iNTT (from
   values) and the coset LDE on them: K1;
2. one all_to_all gives each rank its block of leaves. Leaves are LDE rows
   in bit-reversed order, so rank r owns leaves [r N / D, (r + 1) N / D):
   the points i = D k + rev_{lg D}(r), leaf r N / D + rev(k). The chunk a
   rank sends to r is its LDE at columns rev(r)::D; the padded rows are
   dropped after the exchange;
3. rank r hashes its [num, N / D] columns (K3 or K7: the column layout they
   take, no transpose) and builds its subtree (the tree entry of K2 or K6)
   down to its 2^cap_height / D cap entries, or to its root when D >
   2^cap_height;
4. one all_gather of the leaves and of every layer gives each rank the
   whole tree; when D > 2^cap_height every rank builds the levels above
   the D roots.
`commit_sharded_2d` runs step 1 as the four-step LDE of each polynomial
over the second axis of a 2-D mesh (`ntt_sharded`), and steps 2-4 over the
whole mesh. Every rank ends with the tree of the single-device commit, bit
for bit.

`prover_mesh(mesh)` routes the prover's commits through
`commit_values_sharded` (see `fri/oracle.py` for which).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..hash.hashers import POSEIDON
from ..ops import ntt
from ..utils import timing as tracing
from ..utils.bits import log2_strict
from .ntt_sharded import lde_batch_local


def make_mesh(n_devices: int | None = None, axis: str = "col",
              device: str = "cuda") -> DeviceMesh:
    """1-D DeviceMesh over every rank of the process group (one device a
    rank); `n_devices`, when given, must be the world size."""
    n = dist.get_world_size()
    if n_devices not in (None, n):
        raise ValueError(f"make_mesh: {n_devices} devices in a world of {n}"
                         f" ranks")
    return init_device_mesh(device, (n,), mesh_dim_names=(axis,))


_PROVER_MESH: list = []


class prover_mesh:
    """`with prover_mesh(make_mesh()): data.prove(pw)`: every commit of
    the block that can shard runs column-parallel on the mesh, and every
    rank's proof is the single-device proof, byte for byte."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def __enter__(self) -> DeviceMesh:
        _PROVER_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc) -> None:
        _PROVER_MESH.pop()


def current_prover_mesh() -> DeviceMesh | None:
    return _PROVER_MESH[-1] if _PROVER_MESH else None


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[D, *t.shape]: every rank's t, in rank order."""
    out = torch.empty((dist.get_world_size(),) + tuple(t.shape),
                      dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous())
    return out


def _world_order(mesh: DeviceMesh) -> int:
    """This rank's index in the mesh, which must be the world in rank
    order (the leaf exchange runs on the default group)."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"a sharded commit needs a mesh over the whole "
                         f"world in rank order, got {ranks}")
    return dist.get_rank()


def _tree_from_blocks(lde: torch.Tensor, mesh: DeviceMesh, num: int,
                      N: int, cap_height: int, hasher):
    """Steps 2-4 from lde [b, N / S], this rank's block: points
    [s N / S, (s + 1) N / S) of polynomials [c b, (c + 1) b) on a mesh
    (C, S) (S = 1 for a 1-D mesh). Returns (leaves [N, num], layers), the
    same on every rank; built in the span `merkle trees` of the thread's
    active TimingTree and counted in its counter `merkle_trees`, as a
    single-device commit's tree."""
    if not hasher.device:
        raise ValueError(f"a sharded commit hashes on the device; "
                         f"{hasher.name} hashes on the host")
    if lde.device.type != mesh.device_type:
        raise ValueError(f"a {lde.device.type} commit on a "
                         f"{mesh.device_type} mesh")
    _world_order(mesh)
    d = mesh.size()
    c, s = (d, 1) if mesh.ndim == 1 else mesh.shape
    b, M = lde.shape
    if M % d:
        raise ValueError(f"{M} points a rank cannot split {d} ways")
    lg_d = log2_strict(d)
    with tracing.scope("merkle trees", lde.device):
        got = torch.empty((d, b, M // d), dtype=torch.int64,
                          device=lde.device)
        dist.all_to_all_single(got, ntt.leaf_order(
            lde.reshape(b, M // d, d).permute(2, 0, 1), 0).contiguous())
        # block c S + s: polynomials of column rank c, points of sequence
        # rank s
        cols = got.view(c, s, b, M // d).permute(0, 2, 1, 3).reshape(
            c * b, N // d)[:num]                  # [num, N / D], k = i / D
        del got
        digests = ntt.leaf_order(hasher.hash_or_noop_columns(cols), 0)
        leaves = ntt.leaf_order(cols.t(), 0)       # [N / D, num], leaf order
        del cols
        lg_local = log2_strict(N // d)
        local_cap = max(cap_height - lg_d, 0)
        local = [digests] + (hasher.merkle_layers(digests, local_cap)
                             if local_cap < lg_local else [])
        sizes = [t.shape[0] for t in local]
        flat = _all_gather(torch.cat(local))       # [D, sum(sizes), 4]
        layers, off = [], 0
        for size in sizes:
            layers.append(flat[:, off:off + size].reshape(d * size, -1))
            off += size
        if cap_height < lg_d:
            layers += hasher.merkle_layers(layers[-1], cap_height)
        leaves = _all_gather(leaves).view(N, num)
        tracing.count("merkle_trees")
    return leaves, layers


def _padded_block(x: torch.Tensor, c: int, b: int) -> torch.Tensor:
    """Rows [c b, (c + 1) b) of x, zero rows past its end."""
    block = x[c * b:(c + 1) * b].contiguous()
    if block.shape[0] < b:
        block = torch.cat([block, block.new_zeros((b - block.shape[0],)
                                                  + tuple(x.shape[1:]))])
    return block


def commit_values_sharded(mesh: DeviceMesh, values_or_coeffs: torch.Tensor,
                          rate_bits: int, cap_height: int, from_values: bool,
                          hasher=None):
    """The commit of polynomial rows [num, n] (values when `from_values`,
    else coefficients), whole on every rank, with the rows split over a 1-D
    mesh. Returns (coeffs [num, n], leaves [N, num], layers), the same on
    every rank and equal to the single-device commit's."""
    if mesh.ndim != 1:
        raise ValueError("commit_values_sharded takes a 1-D mesh")
    hasher = hasher or POSEIDON
    num, n = values_or_coeffs.shape
    d = mesh.size()
    b = -(-num // d)
    c = _world_order(mesh)
    block = _padded_block(values_or_coeffs, c, b)
    coeffs_block = ntt.ifft(block) if from_values else block
    lde = ntt.coset_lde(coeffs_block, rate_bits)           # [b, N]
    if from_values:
        coeffs = _all_gather(coeffs_block).view(d * b, n)[:num]
    else:
        coeffs = values_or_coeffs
    leaves, layers = _tree_from_blocks(lde, mesh, num, n << rate_bits,
                                       cap_height, hasher)
    return coeffs, leaves, layers


def commit_sharded(mesh: DeviceMesh, coeffs: torch.Tensor, rate_bits: int,
                   cap_height: int):
    """`commit_values_sharded` of coefficients under Poseidon: (leaves
    [N, num] in bit-reversed row order, layers)."""
    return commit_values_sharded(mesh, coeffs, rate_bits, cap_height,
                                 False)[1:]


def commit_sharded_2d(mesh: DeviceMesh, coeffs: torch.Tensor,
                      rate_bits: int, cap_height: int,
                      lg_n2: int | None = None):
    """The commit of coefficient rows [num, n], whole on every rank, over a
    2-D mesh (C, S): rows data-parallel over the first axis (padded to a
    multiple of C), each row's coset LDE the four-step transform over the S
    ranks of the second; leaves and layers over the whole mesh, under
    Poseidon. Returns (leaves [N, num], layers), equal to the single-device
    commit's."""
    num, n = coeffs.shape
    c = mesh.shape[0]
    b = -(-num // c)
    padded = coeffs if b * c == num else _padded_block(coeffs, 0, b * c)
    lde = lde_batch_local(padded, mesh, rate_bits, lg_n2=lg_n2)
    return _tree_from_blocks(lde, mesh, num, n << rate_bits, cap_height,
                             POSEIDON)


def training_step_sharded(mesh: DeviceMesh, wires: torch.Tensor,
                          rate_bits: int, cap_height: int) -> torch.Tensor:
    """One prover step over the mesh: iNTT, coset LDE, leaf exchange and
    tree of wire values [num, n]; returns the cap [2^cap_height, 4]."""
    return commit_values_sharded(mesh, wires, rate_bits, cap_height,
                                 True)[2][-1]
