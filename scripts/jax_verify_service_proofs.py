"""Verify the port's service proofs from the card with the JAX package.

    python scripts/jax_verify_service_proofs.py [chiprun_out]

`chip_smoke.py` writes two proofs that the port made on the GPU:
- `zk_fib_proof.bin`: the zk-fib phase's zero-knowledge proof (fib(31)
  under `standard_recursion_zk_config()`, 2^14 rows after blinding,
  tests/service_circuits.py's builder seed);
- `dummy_2_14_compressed.bin`: the dummy-2^14 proof (dummy_circuit(
  standard_recursion_config(), 14, 4)), compressed.
This script builds each circuit with the JAX package on the CPU, reads the
bytes against it and runs its verifier: the ZK proof directly, the
compressed one after JAX's `decompress`. The JAX package's proof reader
omits the salt of a hiding proof's blinded oracles, so the ZK proof is read
with the reference's leaf widths (`read_salted`). The verifier data absorbs
the circuit digest, so a proof verifies only if the port built the same
circuit. Exits 0 when both verify.
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

import service_circuits as sc  # noqa: E402
from plonky2_tpu.plonk import verifier  # noqa: E402
from plonky2_tpu.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu.plonk.proof import (  # noqa: E402
    OpeningSet, Proof, ProofWithPublicInputs,
)
from plonky2_tpu.recursion.dummy import dummy_circuit  # noqa: E402
from plonky2_tpu.utils import serialization as ser  # noqa: E402

JAX = "plonky2_tpu"
SALT_SIZE = 4


def read_salted(raw: bytes, common) -> ProofWithPublicInputs:
    """deserialize_proof_with_pis with SALT_SIZE more leaf elements in each
    blinded oracle's initial tree when the proof hides (reference:
    read_fri_initial_trees_proof)."""
    buf = ser.Buffer(raw)
    hasher = common.gc.hasher
    ch = common.config.fri_config.cap_height
    caps = [buf.read_cap(ch, hasher) for _ in range(3)]
    openings = OpeningSet(
        constants=buf.read_ext_vec(len(common.constants_range)),
        plonk_sigmas=buf.read_ext_vec(len(common.sigmas_range)),
        wires=buf.read_ext_vec(common.config.num_wires),
        plonk_zs=buf.read_ext_vec(len(common.zs_range)),
        plonk_zs_next=buf.read_ext_vec(len(common.zs_range)),
        partial_products=buf.read_ext_vec(len(common.partial_products_range)),
        quotient_polys=buf.read_ext_vec(common.num_quotient_polys))
    salt = SALT_SIZE if common.fri_params.hiding else 0
    widths = [o.num_polys + (salt if o.blinding else 0)
              for o in common._fri_oracles()]
    opening_proof = ser._read_fri_proof(buf, common.fri_params, widths,
                                        hasher)
    public_inputs = buf.read_field_vec(common.num_public_inputs)
    return ProofWithPublicInputs(
        proof=Proof(wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1],
                    quotient_polys_cap=caps[2], openings=openings,
                    opening_proof=opening_proof),
        public_inputs=public_inputs)


def zk_fib(raw: bytes) -> str:
    data = sc.fib(JAX, 30, sc.ZK_SEED, "standard_recursion_zk_config")[0] \
        .build()
    proof = read_salted(raw, data.common)
    assert ser.serialize_proof_with_pis(proof, data.common) == raw
    verifier.verify(proof, data.verifier_only, data.common)
    return (f"hiding {data.common.fri_params.hiding}, degree "
            f"2^{data.common.degree_bits}, public inputs "
            f"{proof.public_inputs}")


def dummy_compressed(raw: bytes) -> str:
    data = dummy_circuit(CircuitConfig.standard_recursion_config(), 14, 4)[0]
    compressed = ser.deserialize_compressed_proof_with_pis(raw, data.common)
    assert ser.serialize_compressed_proof_with_pis(compressed,
                                                   data.common) == raw
    proof = data.decompress(compressed)
    verifier.verify(proof, data.verifier_only, data.common)
    full = len(ser.serialize_proof_with_pis(proof, data.common))
    return (f"decompressed to {full} bytes, degree "
            f"2^{data.common.degree_bits}, public inputs "
            f"{proof.public_inputs}")


PROOFS = {"zk_fib_proof.bin": zk_fib,
          "dummy_2_14_compressed.bin": dummy_compressed}


def main(out_dir: str) -> int:
    for name, check in PROOFS.items():
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, name), "rb") as f:
            raw = f.read()
        what = check(raw)
        print(f"JAX verifier accepts {name} ({len(raw)} bytes; {what}; "
              f"{time.perf_counter() - t0:.1f} s with the JAX build)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(ROOT, "chiprun_out")))
