"""The port's batch prover on tests/test_batch_prover.py's Poseidon +
random-access circuit: B = 2 and 3 proofs equal, byte for byte, the port's
serial proofs and the JAX package's prove_batch proofs of the same seeded
circuit (the fib(100) half of this check is tests/test_torch_batch.py)."""

import pytest

from test_torch_batch import check_batch, serial_proofs


@pytest.fixture(scope="module")
def hash_serial():
    return serial_proofs("hash_access")


@pytest.mark.parametrize("B", [2, 3])
def test_prove_batch_hash_access_equals_serial_and_jax(hash_serial, B):
    check_batch("hash_access", B, hash_serial)
