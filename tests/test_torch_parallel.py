"""The port's multi-device prover (`plonky2_tpu_torch/parallel/`) on CPU
ranks over gloo, against the JAX package's `parallel/` on the 8-device
virtual mesh of tests/conftest.py, bit for bit (u64 patterns equal).

One module fixture launches two jobs of tests/torch_parallel_worker.py at
once: `collectives` on 4 ranks and `prove` on 2, each rank a process of its
own with one torch thread, a file store in the test's temporary directory
(parallel test workers never share a port) and a timeout of its own. A
worker that fails or times out fails the tests; nothing skips. The ranks
write `.npz` files; the JAX side runs here, from the same numpy seeds. The
port's mesh has 4 ranks where JAX's has 8 devices: both must equal the
single-device result, so their outputs are equal too. Last, in this
process: the commits that JAX keeps on one device under a mesh keep the
single-device commit in the port too."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.fri.oracle import PolynomialBatch
from plonky2_tpu.hash.hashers import HASHERS_BY_NAME
from plonky2_tpu.ops import ntt
from plonky2_tpu.parallel.multihost import global_mesh
from plonky2_tpu.parallel.ntt_sharded import (
    coset_lde_large, coset_lde_large_batch, fft_large,
)
from plonky2_tpu.parallel.sharding import (
    commit_sharded_2d, commit_values_sharded, make_mesh,
    training_step_sharded,
)
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.fri import oracle
from plonky2_tpu_torch.hash.hashers import KECCAK, POSEIDON, POSEIDON_BN128
from plonky2_tpu_torch.parallel import sharding
from plonky2_tpu_torch.plonk.prover import HOST_SPANS, SERIAL_SCOPES

import timing_labels
import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fib100_transcript.json")
RANK_TIMEOUT = 240          # seconds, each rank


def _launch(job: str, world: int, tmp) -> list:
    store, out = tmp / f"{job}.store", tmp
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), str(store),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs: list) -> None:
    failures = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            proc.communicate()
            failures.append(f"rank {rank} timed out after {RANK_TIMEOUT} s")
            continue
        if proc.returncode != 0:
            failures.append(f"rank {rank} exited {proc.returncode}:\n"
                            f"{err[-3000:]}")
    assert not failures, "\n".join(failures)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"collectives": npz, "prove": [npz of rank 0, npz of rank 1]}."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    jobs = {"collectives": _launch("collectives", 4, tmp),
            "prove": _launch("prove", 2, tmp)}
    for procs in jobs.values():
        _wait(procs)
    return {"collectives": dict(np.load(tmp / "collectives.npz")),
            "prove": [dict(np.load(tmp / f"prove_{r}.npz"))
                      for r in range(2)]}


def _gf(seed, *shape):
    rng = np.random.default_rng(seed)
    return GF.from_u64(rng.integers(0, ref.ORDER, size=shape,
                                    dtype=np.uint64))


def _u64(x) -> np.ndarray:
    return np.asarray(x.to_u64())


@pytest.mark.parametrize("key,seed,lg_n,lg_n2", [
    ("fft_lg10_n2_5", 0, 10, 5), ("fft_lg9_n2_3", 3, 9, 3)])
def test_fft_large(ranks, key, seed, lg_n, lg_n2):
    want = _u64(fft_large(_gf(seed, 1 << lg_n), make_mesh(8, axis="x"),
                          lg_n2=lg_n2))
    np.testing.assert_array_equal(ranks["collectives"][key], want)


@pytest.mark.parametrize("key,seed,lg_n,rate,shift", [
    ("lde_lg7_r3", 1, 7, 3, ref.MULTIPLICATIVE_GROUP_GENERATOR),
    ("lde_lg8_r2_shift", 2, 8, 2, 12345)])
def test_coset_lde_large(ranks, key, seed, lg_n, rate, shift):
    want = _u64(coset_lde_large(_gf(seed, 1 << lg_n), make_mesh(8, axis="x"),
                                rate, shift=shift, lg_n2=5))
    np.testing.assert_array_equal(ranks["collectives"][key], want)


def test_host_local_to_global_coset_lde(ranks):
    """Each rank passed only its quarter of 2^10 coefficients
    (tests/multihost_worker.py's sizes); the LDE equals JAX's."""
    want = _u64(ntt.coset_lde(_gf(7, 1 << 10), 2))
    np.testing.assert_array_equal(ranks["collectives"]["h2g_lde_lg10_r2"],
                                  want)


def test_coset_lde_large_batch(ranks):
    want = _u64(coset_lde_large_batch(_gf(21, 8, 1 << 6),
                                      global_mesh(seq_parallel=2), 3,
                                      lg_n2=5))
    np.testing.assert_array_equal(ranks["collectives"]["lde_batch_8_lg6_r3"],
                                  want)


def _assert_tree(got: dict, key: str, leaves, layers) -> None:
    np.testing.assert_array_equal(got[f"{key}/leaves"], leaves)
    assert sum(k.startswith(f"{key}/layer") for k in got) == len(layers)
    for i, layer in enumerate(layers):
        np.testing.assert_array_equal(got[f"{key}/layer{i}"], layer,
                                      err_msg=f"layer {i}")


@pytest.mark.parametrize("case", worker.CASES_2D, ids=lambda c: c[0])
def test_commit_sharded_2d(ranks, case):
    """The (2, 2) mesh against JAX's (4, 2); JAX's 2-D commit takes no row
    count its column axis does not divide, so 6 rows are held against its
    single-device commit."""
    name, num, lg_n, rate, cap = case
    coeffs = _gf(22, num, 1 << lg_n)
    if num % 4 == 0:
        leaves, layers = commit_sharded_2d(global_mesh(seq_parallel=2),
                                           coeffs, rate, cap, lg_n2=5)
        leaves, layers = _u64(leaves), [_u64(x) for x in layers]
    else:
        tree = PolynomialBatch.from_coeffs(coeffs, rate, False,
                                           cap).merkle_tree
        leaves, layers = tree.leaves_host(), tree._layers_host()
    _assert_tree(ranks["collectives"], name, leaves, layers)


@pytest.mark.parametrize("case", worker.VALUES_CASES, ids=lambda c: c[0])
def test_commit_values_sharded(ranks, case):
    name, num, lg_n, rate, cap, from_values, hasher = case
    coeffs, leaves, layers = commit_values_sharded(
        make_mesh(8), _gf(11, num, 1 << lg_n), rate, cap, from_values,
        HASHERS_BY_NAME[hasher])
    got = ranks["collectives"]
    np.testing.assert_array_equal(got[f"{name}/coeffs"], _u64(coeffs))
    _assert_tree(got, name, _u64(leaves), [_u64(x) for x in layers])


def test_training_step_sharded(ranks):
    lo, hi = training_step_sharded(make_mesh(8), _gf(12, 8, 1 << 5), 2, 1)
    np.testing.assert_array_equal(ranks["collectives"]["training_step_cap"],
                                  _u64(GF(lo, hi)))


def test_fib100_under_prover_mesh(ranks):
    """fib(100) proved on 2 ranks under prover_mesh: both ranks' bytes equal
    the serial proof's and the golden transcript's; its three commits
    (wires, Z and partial products, quotient) went through the mesh; each
    rank's TimingTree recorded the serial prove's eight scopes in order,
    the port's HOST_SPANS between them and the scopes inside round 3 and
    FRI."""
    r0, r1 = ranks["prove"]
    with open(GOLDEN) as f:
        golden = bytes.fromhex(json.load(f)["proof_hex"])
    for r in (r0, r1):
        assert r["fib100_mesh"].tobytes() == golden
        assert r["fib100_serial"].tobytes() == golden
        scopes = r["mesh_scopes"].tobytes().decode().split("\n")
        assert [label for label in scopes if label not in HOST_SPANS] == \
            list(SERIAL_SCOPES)
        assert scopes == timing_labels.plonk_top(SERIAL_SCOPES, 1)
        assert json.loads(r["mesh_nested"].tobytes()) == json.loads(
            r["mesh_expected_nested"].tobytes())
    assert r0["mesh_commits"][0] == 3


def test_stark_prove_under_prover_mesh(ranks):
    """tests/test_starky.py's mesh test: a 2^5 FibonacciStark proved under
    the mesh equals its serial proof (the whole proof object), on both
    ranks; its trace and quotient commits went through the mesh."""
    r0, r1 = ranks["prove"]
    for r in (r0, r1):
        assert r["stark_mesh"].tobytes() == r["stark_serial"].tobytes()
    assert r0["stark_mesh"].tobytes() == r1["stark_mesh"].tobytes()
    assert r0["mesh_commits"][1] == 2


def test_hook_keeps_single_device_commits(monkeypatch):
    """Under a prover_mesh, the commits JAX keeps on one device keep the
    single-device commit too: a blinded one, a host hasher's (Keccak,
    PoseidonBN128) and a batch of B > 1 proofs. Their trees equal those
    made with no mesh, and the mesh's commit is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a single-device commit went to the mesh")
    monkeypatch.setattr(sharding, "commit_values_sharded", refuse)
    rng = np.random.default_rng(5)
    coeffs = gl.from_u64(rng.integers(0, ref.ORDER, size=(6, 2, 1 << 4),
                                      dtype=np.uint64), "cpu")
    cases = [(coeffs, POSEIDON, False), (coeffs[:, :1], KECCAK, False),
             (coeffs[:, :1], POSEIDON_BN128, False),
             (coeffs[:, :1], POSEIDON, True)]

    def commit(c, hasher, blinding):
        batch = oracle.commit_batch(c, 2, 1, hasher, blinding,
                                    np.random.default_rng(1))
        return batch.leaves, [b.merkle_tree.cap_digests()
                              for b in batch.batches]
    want = [commit(*case) for case in cases]
    with sharding.prover_mesh(object()):
        got = [commit(*case) for case in cases]
        keccak = oracle.PolynomialBatch.from_values(coeffs[:, 0], 2, 1,
                                                    KECCAK)
    for (gl_, gc), (wl, wc) in zip(got, want):
        assert torch.equal(gl_, wl) and gc == wc
    assert keccak.merkle_tree.cap_digests() == \
        oracle.PolynomialBatch.from_values(coeffs[:, 0], 2, 1,
                                           KECCAK).merkle_tree.cap_digests()
