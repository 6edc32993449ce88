"""Make tests/golden/zk_fib_small.bin: a zero-knowledge proof of the small
ZK fib circuit (tests/service_circuits.py `zk_fib`) by the JAX package, and
tests/golden/zk_fib_small_verifier.bin, its verifier data (the constants'
cap and the circuit digest, `serialize_verifier_data`).

    python scripts/jax_zk_golden.py [out_dir]

The JAX package draws each commit's salt from an unseeded
`numpy.random.default_rng()` (plonky2_tpu/fri/oracle.py). For a proof that
can be reproduced, this script hands those draws one generator seeded with
`ZK_SALT_SEED`, by replacing `numpy.random.default_rng` while the proof is
made: a call without a seed returns that generator. The package is not
edited. The builder's seed fixes the blinding rows' random values. The port
makes the same bytes with `prove(..., rng=numpy.random.default_rng(
ZK_SALT_SEED))`. The script verifies the proof with the JAX verifier before
writing it.
"""

import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import service_circuits as sc  # noqa: E402
from plonky2_tpu.utils.serialization import (  # noqa: E402
    serialize_proof_with_pis, serialize_verifier_data,
)

JAX = "plonky2_tpu"


def seeded_salts(seed: int):
    """A replacement for numpy.random.default_rng whose seedless calls all
    return one generator seeded with `seed`."""
    real = np.random.default_rng
    salts = real(seed)

    def default_rng(*args, **kwargs):
        return salts if not args and not kwargs else real(*args, **kwargs)
    return real, default_rng


def main(out_dir: str) -> int:
    t0 = time.perf_counter()
    builder, inputs = sc.zk_fib(JAX)
    data = builder.build()
    t1 = time.perf_counter()
    real, patched = seeded_salts(sc.ZK_SALT_SEED)
    np.random.default_rng = patched
    try:
        # op by op: XLA:CPU compiles the FRI fold programs of a 2^9 circuit
        # for longer than 20 minutes
        with jax.disable_jit():
            proof = data.prove(inputs(*sc.ZK_INPUTS))
    finally:
        np.random.default_rng = real
    t2 = time.perf_counter()
    data.verify(proof)
    raw = serialize_proof_with_pis(proof, data.common)
    out_path = os.path.join(out_dir, "zk_fib_small.bin")
    with open(out_path, "wb") as f:
        f.write(raw)
    with open(os.path.join(out_dir, "zk_fib_small_verifier.bin"), "wb") as f:
        f.write(serialize_verifier_data(data.verifier_only))
    print(f"{len(raw)} bytes to {out_path}: degree 2^"
          f"{data.common.degree_bits}, {len(data.common.gates)} gate types, "
          f"public inputs {proof.public_inputs}; JAX build {t1 - t0:.1f} s, "
          f"prove {t2 - t1:.1f} s, verify {time.perf_counter() - t2:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "golden")))
