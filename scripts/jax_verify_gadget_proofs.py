"""Verify the port's gadget-circuit proofs with the JAX package's verifier.

    python scripts/jax_verify_gadget_proofs.py [chiprun_out]

`chip_smoke.py` writes the proof bytes of three circuits that the port
built and proved on the GPU: the in-circuit Schnorr verification over
EcGFp5 (`schnorr_ecgfp5_proof.bin`), the secp256k1 add/double circuit
(`secp256k1_curve_proof.bin`) and the two-table lookup circuit
(`lookups_proof.bin`). This script builds each with the JAX package on the
CPU from the same seeds (tests/gadget_circuits.py), reads the bytes against
it and runs `plonk.verifier.verify`. The verifier data absorbs the circuit
digest, so a proof verifies only if the port built the same circuit with
the same constants and sigmas. Exits 0 when all three verify; the JAX build
of the Schnorr circuit (2^12) takes about 15 s.
"""

import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import gadget_circuits  # noqa: E402
from plonky2_tpu.plonk import verifier  # noqa: E402
from plonky2_tpu.utils.serialization import (  # noqa: E402
    deserialize_proof_with_pis, serialize_proof_with_pis,
)

JAX = "plonky2_tpu"
# proof file -> the circuit's builder in tests/gadget_circuits.py
PROOFS = {"schnorr_ecgfp5_proof.bin": gadget_circuits.schnorr,
          "secp256k1_curve_proof.bin": gadget_circuits.secp256k1_curve,
          "lookups_proof.bin": gadget_circuits.two_luts}


def main(out_dir: str) -> int:
    for name, circuit in PROOFS.items():
        t0 = time.perf_counter()
        data = circuit(JAX)[0].build()
        t1 = time.perf_counter()
        with open(os.path.join(out_dir, name), "rb") as f:
            raw = f.read()
        proof = deserialize_proof_with_pis(raw, data.common)
        assert serialize_proof_with_pis(proof, data.common) == raw
        verifier.verify(proof, data.verifier_only, data.common)
        print(f"JAX verifier accepts {name} ({len(raw)} bytes; degree "
              f"2^{data.common.degree_bits}, {len(data.common.gates)} gate "
              f"types, public inputs {proof.public_inputs[:4]}; JAX build "
              f"{t1 - t0:.1f} s, read and verify "
              f"{time.perf_counter() - t1:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(ROOT, "chiprun_out")))
