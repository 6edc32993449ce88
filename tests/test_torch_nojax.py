"""The port stands alone: in a subprocess where `import jax` and `import
plonky2_tpu` both fail, import plonky2_tpu_torch, then build, prove and
verify fib(21) on the CPU under each of the four hasher configs,
FibonacciStark at 2^5 with the port's starky, and a batch prove, a
compression, a circuit load and a zero-knowledge prove, and check that no
module of JAX or of the JAX package was loaded. An AST scan checks that
no module of the port, chip_smoke.py, the gadget, STARK and service
circuits it proves (tests/gadget_circuits.py, tests/stark_circuits.py,
tests/service_circuits.py, the mesh worker tests/torch_parallel_worker.py),
the port's kernel probe (scripts/torch_poseidon_probe.py) or its
examples (plonky2_tpu_torch/examples/) imports either, and a 2-rank gloo
commit of the port's `parallel/` runs with both blocked. This is what
lets chip_smoke.py run on a machine with no JAX."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
import plonky2_tpu_torch
from plonky2_tpu_torch.hash.hashers import CONFIGS
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig

builder = CircuitBuilder(CircuitConfig.standard_recursion_config(), seed=7)
a, b = builder.add_virtual_target(), builder.add_virtual_target()
prev, cur = a, b
for _ in range(20):
    prev, cur = cur, builder.add(prev, cur)
for t in (a, b, cur):
    builder.register_public_input(t)
data = builder.build(device="cpu", gc=CONFIGS[sys.argv[1]])
pw = PartialWitness()
pw.set_target(a, 0)
pw.set_target(b, 1)
proof = data.prove(pw)
data.verify(proof)
assert proof.public_inputs[2] == 10946, proof.public_inputs
loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "jaxlib", "plonky2_tpu")
          and mod is not None]
assert not loaded, loaded
print("NOJAX_OK")
"""


def _prove_blocked(config):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, config], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def test_port_proves_and_verifies_with_jax_blocked():
    _prove_blocked("PoseidonGoldilocksConfig")


def test_port_proves_poseidon2_with_jax_blocked():
    _prove_blocked("Poseidon2GoldilocksConfig")


@pytest.mark.parametrize("config", ["KeccakGoldilocksConfig",
                                    "PoseidonBN128GoldilocksConfig"])
def test_port_proves_outer_configs_with_jax_blocked(config):
    _prove_blocked(config)


STARK_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
sys.path.insert(0, "tests")
import stark_circuits
from plonky2_tpu_torch.starky.config import StarkConfig
from plonky2_tpu_torch.starky.prover import prove
from plonky2_tpu_torch.starky.verifier import verify_stark_proof

config = StarkConfig.standard_fast_config()
stark, trace, pis = stark_circuits.fibonacci("plonky2_tpu_torch", 1 << 5)
proof = prove(stark, config, trace, pis, device="cpu")
verify_stark_proof(stark, proof, config)
assert proof.public_inputs == [0, 1, 2178309], proof.public_inputs
loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "jaxlib", "plonky2_tpu")
          and mod is not None]
assert not loaded, loaded
print("NOJAX_OK")
"""


def test_port_proves_a_stark_with_jax_blocked():
    """FibonacciStark at 2^5 (tests/stark_circuits.py) proved and verified
    by the port's starky."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", STARK_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


SERVICE_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
sys.path.insert(0, "tests")
import numpy as np
import torch
import service_circuits as sc
torch.set_num_threads(1)   # the test workers share the cores
from plonky2_tpu_torch.plonk.batch_prover import prove_batch
from plonky2_tpu_torch.utils import circuit_serialization as cs
from plonky2_tpu_torch.utils import serialization as ser

P = "plonky2_tpu_torch"
builder, inputs = sc.fib(P, 20, seed=3)
data = builder.build(device="cpu")
proofs = prove_batch(data.prover_only, data.common,
                     [inputs(0, 1), inputs(1, 1)])
for p in proofs:
    data.verify(p)
assert [p.public_inputs[2] for p in proofs] == [10946, 17711]
raw = ser.serialize_compressed_proof_with_pis(data.compress(proofs[0]),
                                              data.common)
data.verify_compressed(ser.deserialize_compressed_proof_with_pis(
    raw, data.common))
loaded = cs.deserialize_circuit_data(cs.serialize_circuit_data(data),
                                     device="cpu")
data.verify(loaded.prove(inputs(0, 1)))
builder, inputs = sc.zk_fib(P, query_rounds=1)
zk = builder.build(device="cpu")
proof = zk.prove(inputs(0, 1), rng=np.random.default_rng(1))
zk.verify(proof)
assert zk.common.fri_params.hiding
loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "jaxlib", "plonky2_tpu")
          and mod is not None]
assert not loaded, loaded
print("NOJAX_OK")
"""


def test_port_serves_proofs_with_jax_blocked():
    """A batch prove, a compression, a circuit saved and loaded and a
    zero-knowledge prove (tests/service_circuits.py) by the port alone."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SERVICE_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def _imported_roots(path):
    """Top-level package of every absolute import in a Python source."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "gadget_circuits.py"),
             os.path.join(ROOT, "tests", "stark_circuits.py"),
             os.path.join(ROOT, "tests", "service_circuits.py"),
             os.path.join(ROOT, "tests", "torch_parallel_worker.py"),
             os.path.join(ROOT, "scripts", "torch_poseidon_probe.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "plonky2_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f)
           if m in ("jax", "jaxlib", "plonky2_tpu")]
    assert not bad, bad


# the modules of the recursive verifier circuit, and of conditional and
# cyclic recursion
RECURSION_MODULES = [
    "plonky2_tpu_torch.gates.ext_algebra",
    "plonky2_tpu_torch.gates.extension_gates",
    "plonky2_tpu_torch.gates.misc_gates",
    "plonky2_tpu_torch.gates.coset_interpolation_gate",
    "plonky2_tpu_torch.gates.target_algebra",
    "plonky2_tpu_torch.gadgets.extension",
    "plonky2_tpu_torch.gadgets.misc",
    "plonky2_tpu_torch.iop.recursive_challenger",
    "plonky2_tpu_torch.recursion.targets",
    "plonky2_tpu_torch.recursion.fri_verifier",
    "plonky2_tpu_torch.recursion.verifier",
    "plonky2_tpu_torch.recursion.dummy",
    "plonky2_tpu_torch.recursion.conditional",
    "plonky2_tpu_torch.recursion.cyclic",
]
# the host hashers of the outer-proof configs
OUTER_CONFIG_MODULES = [
    "plonky2_tpu_torch.hash.keccak",
    "plonky2_tpu_torch.hash.poseidon_bn128",
]
# the gadget crates: u32, BigUint, nonnative, secp256k1, EcGFp5, lookups and
# the last gates
GADGET_MODULES = [
    "plonky2_tpu_torch.gadgets.u32",
    "plonky2_tpu_torch.ecdsa.biguint",
    "plonky2_tpu_torch.ecdsa.nonnative",
    "plonky2_tpu_torch.ecdsa.curve",
    "plonky2_tpu_torch.ecdsa.curve_gadgets",
    "plonky2_tpu_torch.ecgfp5.scalar_field",
    "plonky2_tpu_torch.ecgfp5.curve",
    "plonky2_tpu_torch.ecgfp5.gadgets",
    "plonky2_tpu_torch.gates.lookup_gates",
    "plonky2_tpu_torch.gates.interpolation_gates",
]

# the STARK system, its timing tree and the test harnesses
STARKY_MODULES = [
    "plonky2_tpu_torch.utils.timing",
    "plonky2_tpu_torch.gates.gate_testing",
] + [f"plonky2_tpu_torch.starky.{m}" for m in (
    "config", "stark", "proof", "fibonacci_stark", "unconstrained_stark",
    "permutation_stark", "lookup", "cross_table_lookup", "prover",
    "verifier", "recursive_verifier", "stark_testing")]

# the proving-service surface: batches, compression, circuit files
SERVICE_MODULES = [
    "plonky2_tpu_torch.plonk.batch_prover",
    "plonky2_tpu_torch.plonk.compressed_proof",
    "plonky2_tpu_torch.fri.compressed",
    "plonky2_tpu_torch.hash.path_compression",
    "plonky2_tpu_torch.utils.circuit_serialization",
]

# the multi-device prover and the last modules of the JAX package
PARALLEL_MODULES = [
    "plonky2_tpu_torch.parallel.multihost",
    "plonky2_tpu_torch.parallel.ntt_sharded",
    "plonky2_tpu_torch.parallel.sharding",
    "plonky2_tpu_torch.utils.context_tree",
    "plonky2_tpu_torch.utils.circom_export",
]

# the port's entry points, one for each of the JAX package's examples
EXAMPLE_MODULES = [f"plonky2_tpu_torch.examples.{m}" for m in (
    "_common", "fibonacci", "factorial", "range_check", "square_root",
    "fibonacci_serialization", "batch_prove", "bench_recursion")]

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
import plonky2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plonky2_tpu_torch.__path__,
                                                "plonky2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("\n".join(names))
"""


def test_every_port_module_imports_with_jax_blocked():
    """Each module of the port, the recursion's, the outer configs' hashers,
    the gadget crates, starky and the examples included, imports where
    `import jax` and `import plonky2_tpu` fail."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = proc.stdout.split()
    listed = (RECURSION_MODULES + OUTER_CONFIG_MODULES + GADGET_MODULES
              + STARKY_MODULES + SERVICE_MODULES + PARALLEL_MODULES
              + EXAMPLE_MODULES)
    assert set(listed) <= set(names)
    files = {os.path.relpath(os.path.join(d, n), ROOT)
             for d, _, ns in os.walk(os.path.join(ROOT, "plonky2_tpu_torch"))
             for n in ns if n.endswith(".py")}
    assert {m.replace(".", "/") + ".py" for m in listed} <= files


def test_port_commits_on_two_gloo_ranks_with_jax_blocked(tmp_path):
    """tests/torch_parallel_worker.py's `commit` job: two ranks, each with
    `import jax` and `import plonky2_tpu` failing, commit ten polynomials
    over a 1-D mesh and hold the tree against the single-device commit."""
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker, "commit", str(r), "2",
         str(tmp_path / "store"), str(tmp_path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:
            proc.kill()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-4000:]
    assert "COMMIT_OK" in outs[0][0]
