"""The port's entry points (plonky2_tpu_torch/examples/) on the CPU, each run
through its `main(argv)` with `--device cpu --seed 1234`:
- fibonacci, factorial, range_check and square_root print the JAX
  examples' value lines and prove the bytes of the JAX package's proofs:
  fibonacci tests/golden/fib100_transcript.json's, the others
  tests/golden/example_<name>.bin (scripts/jax_examples_golden.py runs the
  JAX examples' own `main()` with the builder seeded; running them here
  would cost minutes of XLA compiles);
- fibonacci_serialization: the loaded circuit proves the bytes the
  original proves;
- batch_prove at B = 2: each proof equals a serial prove of its witness;
- bench_recursion: its wrap of a 2^5 dummy proof, laid out on the host,
  runs its witness fixpoint to the inner proof's public inputs (a wrap of
  2^12 rows or more proves on the card only: chip_smoke.py's examples
  phase);
- every example refuses the default device where there is no card."""

import json
import math
import os

import pytest
import torch

from plonky2_tpu_torch.examples import (
    batch_prove, bench_recursion, factorial, fibonacci,
    fibonacci_serialization, range_check, square_root,
)
from plonky2_tpu_torch.examples._common import fib_circuit
from plonky2_tpu_torch.field import reference as ref
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CPU = ["--device", "cpu", "--seed", "1234"]
P = ref.ORDER


def fib100() -> int:
    a, b = 0, 1
    for _ in range(99):
        a, b = b, (a + b) % P
    return b


def golden_bytes(name: str) -> bytes:
    if name == "fibonacci":
        with open(os.path.join(GOLDEN_DIR, "fib100_transcript.json")) as f:
            return bytes.fromhex(json.load(f)["proof_hex"])
    with open(os.path.join(GOLDEN_DIR, f"example_{name}.bin"), "rb") as f:
        return f.read()


# example -> (module, the value lines the JAX example prints)
GOLDEN_EXAMPLES = {
    "fibonacci": (fibonacci, [
        f"100th Fibonacci number (mod p): {fib100()}", "proof verified"]),
    "factorial": (factorial, [
        f"100! (mod p): {math.factorial(100) % P}", "proof verified"]),
    "range_check": (range_check, [
        "value 42 is in [0, 2^6)", "proof verified"]),
    "square_root": (square_root, [
        f"proved knowledge of sqrt({square_root.X_VALUE ** 2 % P})",
        "serialization roundtrip OK ({} bytes)"]),
}


@pytest.mark.parametrize("name", list(GOLDEN_EXAMPLES))
def test_example_prints_jax_s_values_and_proves_its_bytes(name, capsys):
    module, lines = GOLDEN_EXAMPLES[name]
    data, proof = module.main(CPU)
    raw = serialize_proof_with_pis(proof, data.common)
    assert raw == golden_bytes(name)
    assert capsys.readouterr().out.splitlines() == [
        line.format(len(raw)) for line in lines]


def test_square_root_generator_finds_a_root():
    for a in (0, 1, 4, 9 * 9, square_root.X_VALUE ** 2 % P, P - 1):
        r = square_root.sqrt(a)
        assert r * r % P == a
    with pytest.raises(ValueError, match="residue"):
        square_root.sqrt(ref.MULTIPLICATIVE_GROUP_GENERATOR)


def test_fibonacci_serialization_proves_the_original_s_bytes(capsys):
    data, restored, pw, proof = fibonacci_serialization.main(CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == [f"100th Fibonacci number (mod p): {fib100()}",
                       "proof from reloaded circuit verified"]
    assert out[0].startswith("CircuitData: ")
    want = data.prove(pw)
    assert serialize_proof_with_pis(proof, restored.common) == \
        serialize_proof_with_pis(want, data.common)


def test_batch_prove_equals_serial_proves(capsys):
    data, proofs = batch_prove.main(["2"] + CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("2 proofs in ") and \
        out[1].endswith(" all verified")
    assert out[2] == f"fib(100) for (a=0,b=1): {fib100()}"
    builder, a, b, _ = fib_circuit(1234)
    serial = builder.build(device="cpu")
    for proof, pw in zip(proofs, batch_prove.witnesses(a, b, 2)):
        assert serialize_proof_with_pis(proof, data.common) == \
            serialize_proof_with_pis(serial.prove(pw), serial.common)
    assert [p.public_inputs[:2] for p in proofs] == [[0, 1], [1, 2]]


def test_bench_recursion_wrap_runs_its_witness_on_the_host():
    inner, pis = dummy_circuit(CircuitConfig.standard_recursion_config(), 5,
                               4, device="cpu")
    proof = dummy_proof(inner, pis, {0: 42})
    builder, witness = bench_recursion.wrap_circuit(inner, 1234)
    host = builder.build_host()
    values = generate_partial_witness(witness(proof), host, host.common)
    assert [values.get(t) for t in host.public_inputs] == \
        proof.public_inputs == [42, 0, 0, 0]
    assert host.common.degree_bits >= 12


@pytest.mark.parametrize("module", [
    fibonacci, factorial, range_check, square_root, fibonacci_serialization,
    batch_prove, bench_recursion], ids=lambda m: m.__name__.split(".")[-1])
def test_example_refuses_the_card_where_there_is_none(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
