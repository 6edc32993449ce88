"""One rank of a CPU job over torch.distributed (gloo) driving the port's
`parallel/` package; tests/test_torch_parallel.py and
tests/test_torch_nojax.py launch it. It imports torch, numpy and the port
only (`main` blocks JAX and the JAX package), and writes its results to
`.npz` files that the parent, which has JAX, compares.

    python tests/torch_parallel_worker.py <job> <rank> <world> <store> <out>

`store` is the path of a file store (`init_method="file://<store>"`), so
parallel jobs never share a port. Jobs:
- `collectives` (4 ranks): fft_large, coset_lde_large (two shifts, two
  splits), host_local_to_global + coset_lde_large, coset_lde_large_batch
  and commit_sharded_2d on a (2, 2) mesh, commit_values_sharded on the 1-D
  mesh (Poseidon and Poseidon2, from values and from coefficients, cap 0,
  a cap above the rank count and a row count 4 does not divide); rank 0
  writes `collectives.npz`;
- `prove` (2 ranks): fib(100) (the golden circuit: seed 1234) and a 2^5
  FibonacciStark proved serially and under `prover_mesh`; each rank writes
  `prove_<rank>.npz` with both proofs' bytes;
- `commit` (2 ranks): one commit_values_sharded held against the
  single-device commit in the worker; rank 0 prints COMMIT_OK.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

P = (1 << 64) - (1 << 32) + 1
DEV = torch.device("cpu")


def _rand(seed, *shape):
    from plonky2_tpu_torch.field import goldilocks as gl
    rng = np.random.default_rng(seed)
    return gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), DEV)


def _u64(t):
    from plonky2_tpu_torch.field import goldilocks as gl
    return gl.to_u64(t)


def _layers(out, key, layers):
    for i, layer in enumerate(layers):
        out[f"{key}/layer{i}"] = _u64(layer)


# (name, num, lg_n, rate_bits, cap_height, from_values, hasher)
VALUES_CASES = [("cv_poseidon", 16, 6, 3, 2, False, "poseidon"),
                ("cv_values_cap0", 16, 6, 3, 0, True, "poseidon"),
                ("cv_num6_cap4", 6, 6, 3, 4, True, "poseidon"),
                ("cv_poseidon2", 8, 6, 3, 1, False, "poseidon2")]
# (name, num, lg_n, rate_bits, cap_height)
CASES_2D = [("2d_cap2", 8, 6, 3, 2), ("2d_cap0", 8, 6, 3, 0),
            ("2d_num6_cap4", 6, 6, 3, 4)]


def collectives(rank, world):
    from plonky2_tpu_torch.hash.hashers import POSEIDON, POSEIDON2
    from plonky2_tpu_torch.parallel import multihost, ntt_sharded, sharding

    mesh = sharding.make_mesh(device="cpu", axis="x")
    out = {}

    def put(key, dt):
        full = dt.full_tensor()
        out[key] = _u64(full)

    put("fft_lg10_n2_5", ntt_sharded.fft_large(_rand(0, 1 << 10), mesh,
                                               lg_n2=5))
    put("fft_lg9_n2_3", ntt_sharded.fft_large(_rand(3, 1 << 9), mesh,
                                              lg_n2=3))
    put("lde_lg7_r3", ntt_sharded.coset_lde_large(_rand(1, 1 << 7), mesh, 3,
                                                  lg_n2=5))
    put("lde_lg8_r2_shift", ntt_sharded.coset_lde_large(
        _rand(2, 1 << 8), mesh, 2, shift=12345, lg_n2=5))

    # each rank passes only its contiguous block of the coefficients
    gmesh = multihost.global_mesh(device="cpu")
    full = _rand(7, 1 << 10)
    block = full.shape[0] // world
    local = full[rank * block:(rank + 1) * block].clone()
    dt = multihost.host_local_to_global(local, gmesh, ("col",))
    assert tuple(dt.shape) == (1 << 10,), dt.shape
    put("h2g_lde_lg10_r2", ntt_sharded.coset_lde_large(dt, gmesh, 2))

    mesh2d = multihost.global_mesh(seq_parallel=2, device="cpu")
    assert tuple(mesh2d.shape) == (2, 2), mesh2d.shape
    assert mesh2d.mesh_dim_names == ("col", "x"), mesh2d.mesh_dim_names
    put("lde_batch_8_lg6_r3", ntt_sharded.coset_lde_large_batch(
        _rand(21, 8, 1 << 6), mesh2d, 3, lg_n2=5))

    for name, num, lg_n, rate, cap in CASES_2D:
        leaves, layers = sharding.commit_sharded_2d(
            mesh2d, _rand(22, num, 1 << lg_n), rate, cap, lg_n2=5)
        out[f"{name}/leaves"] = _u64(leaves)
        _layers(out, name, layers)

    hashers = {"poseidon": POSEIDON, "poseidon2": POSEIDON2}
    for name, num, lg_n, rate, cap, from_values, h in VALUES_CASES:
        coeffs, leaves, layers = sharding.commit_values_sharded(
            gmesh, _rand(11, num, 1 << lg_n), rate, cap, from_values,
            hashers[h])
        out[f"{name}/coeffs"] = _u64(coeffs)
        out[f"{name}/leaves"] = _u64(leaves)
        _layers(out, name, layers)
    cap = sharding.training_step_sharded(gmesh, _rand(12, 8, 1 << 5), 2, 1)
    out["training_step_cap"] = _u64(cap)
    return out if rank == 0 else None


def _fib100():
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    return builder.build(device="cpu"), pw


def prove(rank, world):
    import json

    import stark_circuits
    import timing_labels
    from plonky2_tpu_torch.parallel import sharding
    from plonky2_tpu_torch.parallel.sharding import make_mesh, prover_mesh
    from plonky2_tpu_torch.plonk.prover import SERIAL_SCOPES
    from plonky2_tpu_torch.starky.config import StarkConfig
    from plonky2_tpu_torch.starky.prover import prove as stark_prove
    from plonky2_tpu_torch.starky.verifier import verify_stark_proof
    from plonky2_tpu_torch.utils.serialization import (
        serialize_proof_with_pis,
    )
    from plonky2_tpu_torch.utils.timing import TimingTree

    # count the commits that went through the mesh
    commits = []
    sharded = sharding.commit_values_sharded

    def counted(*args, **kw):
        commits.append(args[1].shape)
        return sharded(*args, **kw)
    sharding.commit_values_sharded = counted

    # two builds of one seed: a prove draws the unused wires from the
    # builder's random stream, so each proof starts from a fresh one
    data, pw = _fib100()
    serial = data.prove(pw)
    data, pw = _fib100()
    mesh = make_mesh(device="cpu")
    timing = TimingTree(enabled=True)
    with prover_mesh(mesh):
        meshed = data.prove(pw, timing)
    data.verify(meshed)
    plonk_commits = len(commits)

    config = StarkConfig.standard_fast_config()
    stark, trace, pis = stark_circuits.fibonacci("plonky2_tpu_torch", 1 << 5)
    stark_serial = stark_prove(stark, config, trace, pis, device="cpu")
    with prover_mesh(mesh):
        stark_meshed = stark_prove(stark, config, trace, pis, device="cpu")
    verify_stark_proof(stark, stark_meshed, config)
    b = lambda x: np.frombuffer(x, dtype=np.uint8)
    return {"fib100_serial": b(serialize_proof_with_pis(serial,
                                                        data.common)),
            "fib100_mesh": b(serialize_proof_with_pis(meshed, data.common)),
            "stark_serial": b(pickle.dumps(stark_serial)),
            "stark_mesh": b(pickle.dumps(stark_meshed)),
            "mesh_commits": np.asarray([plonk_commits,
                                        len(commits) - plonk_commits]),
            "mesh_scopes": b("\n".join(
                label for depth, label, _ in timing.records
                if depth == 0).encode()),
            "mesh_nested": b(json.dumps(timing_labels.nested(timing))
                             .encode()),
            "mesh_expected_nested": b(json.dumps(timing_labels.plonk_nested(
                data.common, SERIAL_SCOPES, 1)).encode())}


def commit(rank, world):
    from plonky2_tpu_torch.fri.oracle import PolynomialBatch
    from plonky2_tpu_torch.hash.hashers import POSEIDON
    from plonky2_tpu_torch.parallel.sharding import (
        commit_values_sharded, make_mesh,
    )

    values = _rand(5, 10, 1 << 5)
    _, leaves, layers = commit_values_sharded(make_mesh(device="cpu"),
                                              values, 2, 1, True, POSEIDON)
    want = PolynomialBatch.from_values(values, 2, 1, POSEIDON).merkle_tree
    assert torch.equal(leaves, want.leaves)
    assert len(layers) == len(want.layers)
    assert all(torch.equal(a, b) for a, b in zip(layers, want.layers))
    loaded = [m for m, mod in sys.modules.items()
              if m.split(".")[0] in ("jax", "jaxlib", "plonky2_tpu")
              and mod is not None]
    assert not loaded, loaded
    if rank == 0:
        print("COMMIT_OK", flush=True)
    return None


JOBS = {"collectives": collectives, "prove": prove, "commit": commit}


def main():
    sys.modules["jax"] = None          # the port must not need JAX
    sys.modules["plonky2_tpu"] = None  # nor the JAX package
    job, rank, world, store, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from plonky2_tpu_torch.parallel.multihost import init_multihost
    init_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        out = JOBS[job](rank, world)
        if out is not None:
            name = job if job != "prove" else f"prove_{rank}"
            np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
