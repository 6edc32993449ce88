"""The gadget circuits that `chip_smoke.py` proves on the card, that
tests/test_torch_gadgets.py holds against the JAX package on the CPU and
that scripts/jax_verify_gadget_proofs.py verifies with the JAX package.

Each function takes the package by name, `"plonky2_tpu"` (JAX) or
`"plonky2_tpu_torch"` (the port), and imports that package's modules only,
so one seed gives one circuit in both and the port's callers load nothing of
JAX. Each returns the builder (seed 1234) with the circuit laid out, unbuilt,
and the partial witness of its inputs:
- `schnorr`: ecgfp5/gadgets.py `schnorr_verify_circuit` under
  `standard_recursion_config()`, on tests/test_schnorr_circuit.py's signed
  message (`random.Random(97)`); `tamper=True` signs with s + 1;
- `secp256k1_curve`: tests/test_curve_gadgets.py's
  `test_curve_add_double_valid` circuit (`random.Random(31)`,
  `standard_ecc_config()`) and its add, double and neg outputs beside the
  native curve's values;
- `two_luts`: tests/test_lookup.py's `test_two_luts` circuit and its
  expected public inputs.
"""

import importlib
import random

SEED = 1234


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _builder(pkg: str, config: str):
    config_cls = _mod(pkg, "plonk.config").CircuitConfig
    return _mod(pkg, "plonk.circuit_builder").CircuitBuilder(
        getattr(config_cls, config)(), seed=SEED)


def schnorr_signature(pkg: str, tamper: bool = False):
    """(message, public key, signature) of test_schnorr_circuit.py's
    `_signed_message`; with `tamper`, the signature's s + 1."""
    ec = _mod(pkg, "ecgfp5.curve")
    rng = random.Random(97)
    pk, sk = ec.schnorr_keygen(rng.randrange(1, ec.N))
    msg = [rng.randrange(0xFFFFFFFF00000001) for _ in range(4)]
    sig = ec.schnorr_sign(msg, sk, k=rng.randrange(1, ec.N))
    assert ec.schnorr_verify(msg, pk, sig)
    if tamper:
        sig = ec.SchnorrSignature((sig.s + 1) % ec.N, sig.e)
        assert not ec.schnorr_verify(msg, pk, sig)
    return msg, pk, sig


def schnorr(pkg: str, tamper: bool = False):
    """-> (builder, partial witness): the message, key and signature are
    constants of the circuit, so the witness is empty."""
    builder = _builder(pkg, "standard_recursion_config")
    _mod(pkg, "ecgfp5.gadgets").schnorr_verify_circuit(
        builder, *schnorr_signature(pkg, tamper))
    return builder, _mod(pkg, "iop.witness").PartialWitness()


def secp256k1_curve(pkg: str):
    """-> (builder, partial witness, {"add" | "double" | "neg": (point
    target, (x, y) of the native curve)})."""
    native = _mod(pkg, "ecdsa.curve")
    gadgets = _mod(pkg, "ecdsa.curve_gadgets")
    rng = random.Random(31)
    builder = _builder(pkg, "standard_ecc_config")
    p_val = native.GENERATOR.mul(rng.randrange(2, native.N))
    q_val = native.GENERATOR.mul(rng.randrange(2, native.N))
    p = builder.add_virtual_affine_point_target()
    q = builder.add_virtual_affine_point_target()
    builder.curve_assert_valid(p)
    s = builder.curve_add(p, q)
    d = builder.curve_double(p)
    n = builder.curve_neg(p)
    pw = _mod(pkg, "iop.witness").PartialWitness()
    gadgets.set_affine_point_target(pw, p, p_val)
    gadgets.set_affine_point_target(pw, q, q_val)
    sv, dv = p_val.add(q_val), p_val.double()
    return builder, pw, {"add": (s, (sv.x, sv.y)),
                         "double": (d, (dv.x, dv.y)),
                         "neg": (n, (p_val.x, (-p_val.y) % native.P))}


def point_value(pkg: str, witness, t) -> tuple:
    """(x, y) of an affine point target in a witness."""
    get = _mod(pkg, "ecdsa.nonnative").get_nonnative_target
    return get(witness, t.x), get(witness, t.y)


def two_luts(pkg: str):
    """-> (builder, partial witness, expected public inputs)."""
    builder = _builder(pkg, "standard_recursion_config")
    a = builder.add_virtual_target()
    i1 = builder.add_lookup_table_from_pairs([(i, i + 1) for i in range(16)])
    i2 = builder.add_lookup_table_from_pairs([(i, 2 * i) for i in range(16)])
    o1 = builder.add_lookup_from_index(a, i1)
    o2 = builder.add_lookup_from_index(o1, i2)
    for t in (a, o1, o2):
        builder.register_public_input(t)
    pw = _mod(pkg, "iop.witness").PartialWitness()
    pw.set_target(a, 5)
    return builder, pw, [5, 6, 12]
