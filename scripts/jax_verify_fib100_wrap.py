"""Verify the port's fib100-wrap proof with the JAX package's verifier.

    python scripts/jax_verify_fib100_wrap.py chiprun_out/fib100_wrap_proof.bin
    python scripts/jax_verify_fib100_wrap.py --gc KeccakGoldilocksConfig \
        chiprun_out/fib100_wrap_keccak_proof.bin
    python scripts/jax_verify_fib100_wrap.py \
        --gc PoseidonBN128GoldilocksConfig chiprun_out/fib100_wrap_bn128_proof.bin

`chip_smoke.py` writes the proof bytes of the recursive verifier circuit of
fib(100) that the port built and proved on the GPU, under the Poseidon
config and, as an outer proof, under the Keccak and PoseidonBN128 configs.
This script builds the same wrap with the JAX package on the CPU
(tests/golden_common.py's build_fib100_wrap circuit, without its prove:
seed 1234, standard_recursion_config(), the fib(100) circuit as its inner
one, committed under `--gc`, default PoseidonGoldilocksConfig), reads the
bytes against it and runs `plonk.verifier.verify`. The verifier data
absorbs the circuit digest, so the proof verifies only if the port built the
same circuit with the same constants and sigmas. Exits 0 when it verifies.
Under PoseidonBN128GoldilocksConfig the JAX build hashes its 85 x 2^15
commitment in single-threaded C (about a minute).
"""

import argparse
import os
import time
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from plonky2_tpu.hash.hashers import CONFIGS  # noqa: E402
from plonky2_tpu.plonk import verifier  # noqa: E402
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder  # noqa: E402
from plonky2_tpu.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu.recursion.targets import (  # noqa: E402
    add_virtual_proof_with_pis, add_virtual_verifier_data,
)
from plonky2_tpu.recursion.verifier import verify_proof_circuit  # noqa: E402
from plonky2_tpu.utils.serialization import (  # noqa: E402
    deserialize_proof_with_pis, serialize_proof_with_pis,
)
from tests.golden_common import GOLDEN_SEED  # noqa: E402


def fib100_circuit():
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=GOLDEN_SEED)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    return builder.build()


def main(path: str, gc_name: str) -> int:
    t0 = time.perf_counter()
    inner = fib100_circuit()
    config = CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config, seed=GOLDEN_SEED)
    pt = add_virtual_proof_with_pis(builder, inner.common)
    vt = add_virtual_verifier_data(builder, config.fri_config.cap_height)
    verify_proof_circuit(builder, pt, vt, inner.common)
    outer = builder.build(gc=CONFIGS[gc_name])
    t1 = time.perf_counter()
    with open(path, "rb") as f:
        raw = f.read()
    proof = deserialize_proof_with_pis(raw, outer.common)
    assert serialize_proof_with_pis(proof, outer.common) == raw
    verifier.verify(proof, outer.verifier_only, outer.common)
    digest = outer.verifier_only.circuit_digest
    digest = (digest.hex() if isinstance(digest, bytes)
              else [int(x) for x in digest])
    print(f"JAX verifier accepts {path} under {gc_name} ({len(raw)} bytes; "
          f"wrap degree 2^{outer.common.degree_bits}, circuit digest "
          f"{digest}; JAX build {t1 - t0:.1f} s, read and verify "
          f"{time.perf_counter() - t1:.1f} s)")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("proof", help="proof bytes written by chip_smoke.py")
    parser.add_argument("--gc", default="PoseidonGoldilocksConfig",
                        choices=sorted(CONFIGS),
                        help="the GenericConfig the wrap was committed under")
    args = parser.parse_args()
    sys.exit(main(args.proof, args.gc))
