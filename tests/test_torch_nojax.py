"""The port runs without JAX: in a subprocess where `import jax` fails,
import plonky2_tpu_torch, then build, prove and verify fib(21) on the CPU,
and check that no JAX module was loaded. This is what lets chip_smoke.py
run on a machine with no JAX."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None
import plonky2_tpu_torch
from plonky2_tpu.iop.witness import PartialWitness
from plonky2_tpu.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder

builder = CircuitBuilder(CircuitConfig.standard_recursion_config(), seed=7)
a, b = builder.add_virtual_target(), builder.add_virtual_target()
prev, cur = a, b
for _ in range(20):
    prev, cur = cur, builder.add(prev, cur)
for t in (a, b, cur):
    builder.register_public_input(t)
data = builder.build(device="cpu")
pw = PartialWitness()
pw.set_target(a, 0)
pw.set_target(b, 1)
proof = data.prove(pw)
data.verify(proof)
assert proof.public_inputs[2] == 10946, proof.public_inputs
loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "jaxlib") and mod is not None]
assert not loaded, loaded
print("NOJAX_OK")
"""


def test_port_proves_and_verifies_with_jax_blocked():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout
