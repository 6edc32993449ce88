"""Make tests/golden/example_{factorial,range_check,square_root}.bin: the
proof bytes of the JAX package's examples/factorial.py, range_check.py and
square_root.py, each run through its own `main()` with its builder seeded.

    python scripts/jax_examples_golden.py [out_dir]

Each example builds, proves, verifies and prints as it does when run alone.
This script only seeds its CircuitBuilder with GOLDEN_SEED (the builder's
random stream fills the unused public-input-gate wires at prove time) and
keeps the proof that `CircuitData.prove` returns; it writes that proof's
bytes once the example's own `data.verify` has accepted it. The examples are
not edited. The port's examples (`plonky2_tpu_torch/examples/`) make the
same bytes with `--seed 1234`; tests/test_torch_examples.py holds them.
"""

import contextlib
import importlib
import io
import os
import sys
import time

os.environ.setdefault("PLONKY2_TPU_EXAMPLE_PLATFORM", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "examples")]

GOLDEN_SEED = 1234
EXAMPLES = ("factorial", "range_check", "square_root")


def run_example(name: str):
    """The example's main() with a seeded builder: (its printed lines, its
    circuit data, its proof)."""
    module = importlib.import_module(name)    # runs the example's setup()
    import jax
    from plonky2_tpu.plonk.circuit_data import CircuitData
    from plonky2_tpu.utils.serialization import serialize_proof_with_pis

    class SeededBuilder(module.CircuitBuilder):
        def __init__(self, config=None, seed=None):
            super().__init__(config, seed=GOLDEN_SEED)

    made = []
    real_prove = CircuitData.prove

    def prove(self, inputs):
        proof = real_prove(self, inputs)
        made.append((self, proof))
        return proof
    module.CircuitBuilder, CircuitData.prove = SeededBuilder, prove
    out = io.StringIO()
    try:
        # op by op: XLA:CPU compiles the provers' programs at these degrees
        # for longer than 20 minutes (as scripts/jax_zk_golden.py found)
        with contextlib.redirect_stdout(out), jax.disable_jit():
            module.main()
    finally:
        CircuitData.prove = real_prove
    assert len(made) == 1, f"{name}: {len(made)} proofs"
    data, proof = made[0]
    assert "proof verified" in out.getvalue() or \
        "roundtrip OK" in out.getvalue(), out.getvalue()
    return (out.getvalue().splitlines(),
            serialize_proof_with_pis(proof, data.common), data)


def main(out_dir: str) -> int:
    for name in EXAMPLES:
        t0 = time.perf_counter()
        lines, raw, data = run_example(name)
        path = os.path.join(out_dir, f"example_{name}.bin")
        with open(path, "wb") as f:
            f.write(raw)
        print(f"{name}: {len(raw)} bytes to {path}, degree 2^"
              f"{data.common.degree_bits}, {time.perf_counter() - t0:.1f} s;"
              f" the example printed:", flush=True)
        for line in lines:
            print(f"    {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "golden")))
