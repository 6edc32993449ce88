"""Process group, global mesh and global arrays (the JAX package's
parallel/multihost.py).

1. `init_multihost()`: one `torch.distributed.init_process_group` per
   process. The backend follows the device the caller names: NCCL for
   "cuda" (one card a rank), gloo for "cpu".
2. `global_mesh()`: a DeviceMesh over every rank of the job, 1-D ("col",)
   or 2-D (world / seq_parallel, seq_parallel), so column-parallel commits
   and the four-step NTT compose on one mesh.
3. `host_local_to_global()`: each rank passes only its own shard; the
   result is a DTensor over the mesh, so a polynomial never has to exist
   whole on one rank (`ntt_sharded.coset_lde_large` takes it as is).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device: str = "cuda") -> None:
    """Join the job's process group: `coordinator_address` is an init
    method ("tcp://host:port", "file:///path") or "host:port"; None reads
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the environment. On
    "cuda" rank r takes card r mod the cards visible. A second call is a
    no-op."""
    if dist.is_initialized():
        return
    if device not in BACKENDS:
        raise ValueError(f"init_multihost: no backend for device {device!r}")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(BACKENDS[device], init_method=init_method,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id)
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh(seq_parallel: int = 1, axes: tuple[str, str] = ("col", "x"),
                device: str = "cuda") -> DeviceMesh:
    """DeviceMesh over every rank: 1-D (axes[0],) when seq_parallel is 1,
    else (world / seq_parallel, seq_parallel) named `axes`, the second axis
    the four-step NTT's (one polynomial spanning `seq_parallel` ranks)."""
    n = dist.get_world_size()
    if n % seq_parallel:
        raise ValueError(f"global_mesh: {n} ranks, seq_parallel "
                         f"{seq_parallel}")
    if seq_parallel == 1:
        return init_device_mesh(device, (n,), mesh_dim_names=(axes[0],))
    return init_device_mesh(device, (n // seq_parallel, seq_parallel),
                            mesh_dim_names=tuple(axes))


def _placements(mesh: DeviceMesh, spec: tuple) -> list:
    """A PartitionSpec-like tuple (a mesh axis name or None per tensor
    dimension) -> the DTensor placement of each mesh axis."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec) if s == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def host_local_to_global(local: torch.Tensor, mesh: DeviceMesh,
                         spec: tuple) -> DTensor:
    """One global array from per-rank shards: `local` is this rank's block
    under `spec` (e.g. ("x",) shards dimension 0 over the mesh axis "x").
    No rank gathers the whole; `DTensor.full_tensor()` would."""
    if local.device.type != mesh.device_type:
        raise ValueError(f"host_local_to_global: a {local.device.type} shard"
                         f" on a {mesh.device_type} mesh")
    return DTensor.from_local(local, mesh, _placements(mesh, spec),
                              run_check=False)
