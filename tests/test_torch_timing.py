"""The prover's TimingTree scopes (plonk/prover.py) and the profiler capture
(utils/timing.py) of the port on the CPU: a port prove of fib(100) records
the JAX package's eight scope labels in the order the JAX prove records
them, with the same proof bytes as an untimed prove and as the JAX prove;
an enabled tree ends each scope in a synchronize of a CUDA device and a
disabled one in none; PLONKY2_TPU_TIMING makes a default prove print its
scopes; PLONKY2_TPU_PROFILE makes a prove write a Chrome trace that names
every scope. The batch prover's labels are held against JAX's in
tests/test_torch_batch.py, where JAX's `prove_batch` already runs."""

import json
import os
import subprocess
import sys

import pytest
import torch

import service_circuits as sc
from plonky2_tpu.plonk.prover import prove as jprove
from plonky2_tpu.utils.serialization import (
    serialize_proof_with_pis as jserialize,
)
from plonky2_tpu.utils.timing import TimingTree as JTimingTree
from plonky2_tpu_torch.plonk import prover
from plonky2_tpu_torch.utils import timing as timing_mod
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis
from plonky2_tpu_torch.utils.timing import TimingTree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
SEED = 1234


def top_labels(tree: TimingTree) -> list:
    return [label for depth, label, _ in tree.records if depth == 0]


@pytest.fixture(scope="module")
def jax_timed():
    """JAX's fib(100) (seed 1234) proved under an enabled TimingTree: (its
    top-level scope labels in order, its proof bytes)."""
    builder, inputs = sc.fib(JAX, 99, seed=SEED)
    data = builder.build()
    tree = JTimingTree(enabled=True)
    proof = jprove(data.prover_only, data.common, inputs(0, 1), timing=tree)
    return [node[0] for node in tree.root[2]], jserialize(proof, data.common)


def port_proof(timing=None) -> bytes:
    builder, inputs = sc.fib(PORT, 99, seed=SEED)
    data = builder.build(device="cpu")
    proof = data.prove(inputs(0, 1), timing)
    data.verify(proof)
    return serialize_proof_with_pis(proof, data.common)


def test_serial_scopes_are_jax_s_labels_in_order(jax_timed):
    want, _ = jax_timed
    tree = TimingTree(enabled=True)
    port_proof(tree)
    assert top_labels(tree) == want == list(prover.SERIAL_SCOPES)
    assert all(dt >= 0 for _, _, dt in tree.records)
    assert set(tree.seconds()) == set(want)


def test_timing_leaves_the_proof_bytes_unchanged(jax_timed):
    _, want = jax_timed
    timed = port_proof(TimingTree(enabled=True))
    assert timed == port_proof() == port_proof(TimingTree(enabled=False))
    assert timed == want


@pytest.mark.parametrize("enabled", [True, False])
def test_scope_synchronizes_the_device_only_when_enabled(monkeypatch,
                                                         enabled):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    cuda = torch.device("cuda", 0)
    tree = TimingTree(enabled=enabled)
    for label in ("a", "b"):
        with tree.scope(label, cuda):
            pass
    with tree.scope("c", torch.device("cpu")):
        pass
    with tree.scope("d"):
        pass
    assert synced == ([cuda, cuda] if enabled else [])


def test_timing_env_enables_the_default_tree(monkeypatch, capsys):
    monkeypatch.setenv("PLONKY2_TPU_TIMING", "1")
    assert TimingTree().enabled
    builder, inputs = sc.fib(PORT, 20, seed=SEED)
    data = builder.build(device="cpu")
    data.prove(inputs(0, 1))
    printed = [line.split("ms", 1)[1].strip()
               for line in capsys.readouterr().out.splitlines()
               if line.startswith("[timing]")]
    assert printed == list(prover.SERIAL_SCOPES)
    monkeypatch.delenv("PLONKY2_TPU_TIMING")
    assert not TimingTree().enabled


PROFILE_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
sys.path.insert(0, "tests")
import torch
torch.set_num_threads(1)
import service_circuits as sc
from plonky2_tpu_torch.utils.timing import stop_profiler
builder, inputs = sc.fib("plonky2_tpu_torch", 3, seed=5, query_rounds=1)
data = builder.build(device="cpu")
data.verify(data.prove(inputs(0, 1)))
print("TRACE", stop_profiler())
print("AGAIN", stop_profiler())
"""


def test_profile_env_writes_a_trace_naming_every_scope(tmp_path):
    out = tmp_path / "trace"
    env = dict(os.environ, PYTHONPATH=ROOT, PLONKY2_TPU_PROFILE=str(out))
    env.pop("PLONKY2_TPU_TIMING", None)
    proc = subprocess.run([sys.executable, "-c", PROFILE_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("TRACE", "AGAIN")))
    assert lines["AGAIN"] == "None"
    path = lines["TRACE"]
    assert os.path.dirname(path) == str(out) and path.endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(prover.SERIAL_SCOPES) <= names


def test_no_capture_without_the_profile_env(monkeypatch):
    monkeypatch.delenv("PLONKY2_TPU_PROFILE", raising=False)
    TimingTree(enabled=True)
    assert timing_mod._PROFILE is None
    assert timing_mod.stop_profiler() is None
