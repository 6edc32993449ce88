"""Multi-device proving over torch.distributed (reference: the okx fork's
multi-GPU LDE and Merkle building, fri/oracle.rs:288-301 and
hash/merkle_tree.rs:350-438; the JAX package's `parallel/`).

The model is SPMD: every rank runs the whole prover (witness, challengers,
FRI) on its own device and only the commits are distributed, so every rank
ends with the same proof.
- `multihost.py`: the process group (`init_multihost`), a DeviceMesh over
  the world (`global_mesh`) and per-rank shards lifted into one DTensor
  (`host_local_to_global`);
- `ntt_sharded.py`: the four-step NTT, one polynomial spanning the ranks
  of a mesh axis (`fft_large`, `coset_lde_large`, `coset_lde_large_batch`);
- `sharding.py`: column-parallel commits (`commit_values_sharded`, its 2-D
  form `commit_sharded_2d`) and the `prover_mesh` switch that routes the
  prover's commits through them (`fri/oracle.py`).
"""
