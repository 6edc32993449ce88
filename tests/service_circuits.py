"""The proving-service circuits that `chip_smoke.py` proves on the card,
that the tests hold against the JAX package on the CPU, and that
scripts/jax_zk_golden.py and scripts/jax_verify_service_proofs.py build with
the JAX package.

Each function takes the package by name, `"plonky2_tpu"` (JAX) or
`"plonky2_tpu_torch"` (the port), and imports that package's modules only,
so one seed gives one circuit in both and the port's callers load nothing of
JAX. Each returns the builder, laid out and unbuilt, and a function of the
circuit's inputs that returns their PartialWitness:
- `fib`: fib(steps + 1) from inputs (a, b), public inputs a, b and the last
  term, under a named CircuitConfig (`standard_recursion_config` by
  default), the FRI query rounds optionally cut;
- `hash_access`: tests/test_batch_prover.py's Poseidon + random-access
  circuit, inputs (x, index);
- `zk_fib`: the small zero-knowledge fib of tests/golden/zk_fib_small.bin:
  fib(31) under `standard_recursion_zk_config()` with ZK_QUERY_ROUNDS query
  rounds, which blinding lays out at 2^9 rows. Its salts come from
  `numpy.random.default_rng(ZK_SALT_SEED)`.
"""

import dataclasses
import importlib

ZK_SEED = 1234
ZK_STEPS = 30
ZK_QUERY_ROUNDS = 2
ZK_SALT_SEED = 2024
ZK_INPUTS = (0, 1)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def config(pkg: str, name: str = "standard_recursion_config",
           query_rounds: int | None = None):
    cfg = getattr(_mod(pkg, "plonk.config").CircuitConfig, name)()
    if query_rounds is not None:
        cfg = dataclasses.replace(cfg, fri_config=dataclasses.replace(
            cfg.fri_config, num_query_rounds=query_rounds))
    return cfg


def _inputs(pkg: str, targets):
    def inputs(*values):
        pw = _mod(pkg, "iop.witness").PartialWitness()
        for t, v in zip(targets, values):
            pw.set_target(t, v)
        return pw
    return inputs


def fib(pkg: str, steps: int = 99, seed: int = 1234,
        config_name: str = "standard_recursion_config",
        query_rounds: int | None = None):
    builder = _mod(pkg, "plonk.circuit_builder").CircuitBuilder(
        config(pkg, config_name, query_rounds), seed=seed)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(steps):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    return builder, _inputs(pkg, (a, b))


def hash_access(pkg: str, seed: int = 31):
    builder = _mod(pkg, "plonk.circuit_builder").CircuitBuilder(
        config(pkg), seed=seed)
    x = builder.add_virtual_target()
    h = builder.hash_n_to_hash_no_pad([x, x, x])
    idx = builder.add_virtual_target()
    pick = builder.random_access(idx, list(h))
    for t in (x, idx, pick):
        builder.register_public_input(t)
    return builder, _inputs(pkg, (x, idx))


def zk_fib(pkg: str, query_rounds: int = ZK_QUERY_ROUNDS):
    return fib(pkg, ZK_STEPS, ZK_SEED, "standard_recursion_zk_config",
               query_rounds)
