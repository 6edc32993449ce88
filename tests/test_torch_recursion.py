"""The port's recursive verifier circuit (plonky2_tpu_torch/recursion/,
gadgets/, iop/recursive_challenger.py) against the JAX package's.

The wraps are held at the host level: the port builds each wrap with
`build_host()` (rows, selectors, constants, sigmas, generators; no
commitment, whose plain Poseidon over a 2^15 LDE takes minutes on a CPU) and
runs its witness fixpoint; JAX builds the same wrap from its own inner
circuit and fills it from the port's inner proof, read back from the port's
bytes. Equal inputs to the commitment give an equal cap, since the port's
commit is held against JAX on the fib goldens; the wraps' caps, proofs and
verification run on the card (`chip_smoke.py`). Tolerance: exact.
"""

import numpy as np
import pytest

from plonky2_tpu.iop.generator import \
    generate_partial_witness as jgenerate_partial_witness
from plonky2_tpu.iop.witness import PartialWitness as JPartialWitness
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.recursion import dummy as jdummy
from plonky2_tpu.recursion import targets as jtargets
from plonky2_tpu.recursion.verifier import \
    verify_proof_circuit as jverify_proof_circuit
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.convert import circuit_data_from_arrays, common_from
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.hash.hashers import CONFIGS
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.recursive_challenger import RecursiveChallenger
from plonky2_tpu_torch.iop.target import ExtTarget
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof
from plonky2_tpu_torch.recursion.verifier import wrap_circuit
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis

SEED = 1234
RNG = np.random.default_rng(11)
ORDER = (1 << 64) - (1 << 32) + 1


def _fib(builder_cls, config_cls):
    """tests/golden_common.py's seeded fib(100) circuit, unbuilt."""
    builder = builder_cls(config_cls.standard_recursion_config(), seed=SEED)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    return builder, a, b


def _port_inner(case):
    """The port's inner circuit and proof, on the CPU."""
    if case == "fib100":
        builder, a, b = _fib(CircuitBuilder, CircuitConfig)
        data = builder.build(device="cpu")
        pw = PartialWitness()
        pw.set_target(a, 0)
        pw.set_target(b, 1)
        return data, data.prove(pw)
    data, pis = dummy_circuit(CircuitConfig.standard_recursion_config(), 6, 4,
                              device="cpu")
    return data, dummy_proof(data, pis, {0: 42})


def _jax_inner(case):
    """The JAX package's inner circuit (built, never proved)."""
    if case == "fib100":
        return _fib(JBuilder, JCircuitConfig)[0].build()
    return jdummy.dummy_circuit(JCircuitConfig.standard_recursion_config(), 6,
                                4)[0]


def _port_wrap(inner, proof):
    """`build_fib100_wrap`'s circuit in the port: (host circuit, witness)."""
    builder, witness = wrap_circuit(inner)
    host = builder.build_host()
    return host, generate_partial_witness(witness(proof), host, host.common)


def _jax_wrap(jinner, proof_bytes):
    """The same wrap built by JAX, filled from the port's proof bytes."""
    jproof = jser.deserialize_proof_with_pis(proof_bytes, jinner.common)
    config = JCircuitConfig.standard_recursion_config()
    builder = JBuilder(config, seed=SEED)
    pt = jtargets.add_virtual_proof_with_pis(builder, jinner.common)
    vt = jtargets.add_virtual_verifier_data(builder,
                                            config.fri_config.cap_height)
    jverify_proof_circuit(builder, pt, vt, jinner.common)
    outer = builder.build()
    pw = JPartialWitness()
    jtargets.set_proof_with_pis_target(pw, pt, jproof)
    jtargets.set_verifier_data_target(pw, vt, jinner.verifier_only)
    return outer, jgenerate_partial_witness(pw, outer.prover_only,
                                            outer.common)


_CACHE = {}


def _wraps(case):
    """(port host wrap, port witness, JAX wrap, JAX witness), built once."""
    if case not in _CACHE:
        inner, proof = _port_inner(case)
        jinner = _jax_inner(case)
        assert list(inner.verifier_only.circuit_digest) == \
            [int(x) for x in jinner.verifier_only.circuit_digest]
        host, witness = _port_wrap(inner, proof)
        outer, jwitness = _jax_wrap(
            jinner, serialize_proof_with_pis(proof, inner.common))
        _CACHE[case] = host, witness, outer, jwitness
    return _CACHE[case]


CASES = ["fib100", "dummy6"]


@pytest.mark.parametrize("case", CASES)
def test_wrap_structure_matches_jax(case):
    """Gate ids in order, rows, selector groups: the port's CommonCircuitData
    equals the JAX wrap's, field by field."""
    host, _, outer, _ = _wraps(case)
    common = host.common
    assert [g.id() for g in common.gates] == \
        [g.id() for g in outer.common.gates]
    assert common.degree_bits == outer.common.degree_bits == 12
    si, jsi = common.selectors_info, outer.common.selectors_info
    assert si.selector_indices == list(jsi.selector_indices)
    assert si.groups == [range(g.start, g.stop) for g in jsi.groups]
    assert common_from(outer.common) == common
    ids = " ".join(g.id() for g in common.gates)
    # the dummy proof has one arity-16 fold: its wrap interpolates cosets
    # (the exponents of that wrap have at most 20 bits: arithmetic rows,
    # no ExponentiationGate, as in the reference)
    assert ("CosetInterpolationGate" in ids) == (case == "dummy6")
    assert "ExponentiationGate" not in ids


@pytest.mark.parametrize("case", CASES)
def test_wrap_constants_and_sigmas_match_jax(case):
    """The values the commitment takes: [num_constants + routed, 2^12]. The
    sigma rows equal the JAX wrap's sigma values; the selector and constant
    rows, interpolated by the port's plain iNTT, equal the JAX commitment's
    coefficients; the representative maps are equal."""
    host, _, outer, _ = _wraps(case)
    po = outer.prover_only
    nc = outer.common.num_constants
    assert host.constants_sigmas.shape == (nc + 80, 1 << 12)
    np.testing.assert_array_equal(host.constants_sigmas[nc:], po.sigmas)
    np.testing.assert_array_equal(host.subgroup, po.subgroup)
    np.testing.assert_array_equal(host.representative_map,
                                  po.representative_map)
    coeffs = ntt.ifft(gl.from_u64(host.constants_sigmas[:nc], "cpu"))
    np.testing.assert_array_equal(
        gl.to_u64(coeffs),
        po.constants_sigmas_commitment.polynomials.to_u64()[:nc])


@pytest.mark.parametrize("case", CASES)
def test_wrap_witness_matches_jax(case):
    """Every wire of the witness fixpoint, and every target JAX sets."""
    _, witness, _, jwitness = _wraps(case)
    np.testing.assert_array_equal(witness.full_witness(),
                                  jwitness.full_witness())
    assert witness.as_list() == jwitness.values


@pytest.mark.parametrize("case", CASES)
def test_jax_built_wrap_converts(case):
    """`convert.circuit_data_from_arrays` carries the JAX-built wrap over:
    its CommonCircuitData and generators equal the port-built ones."""
    host, _, outer, _ = _wraps(case)
    po = outer.prover_only
    tree = po.constants_sigmas_commitment.merkle_tree
    data = circuit_data_from_arrays(
        outer.common,
        polynomials=po.constants_sigmas_commitment.polynomials.to_u64(),
        leaves=tree.leaves_host(),
        layers=[np.asarray(l) for l in tree._layers_host()],
        sigmas=po.sigmas, subgroup=po.subgroup,
        representative_map=po.representative_map,
        circuit_digest=po.circuit_digest, generators=po.generators,
        public_inputs=po.public_inputs, device="cpu")
    assert data.common == host.common
    assert data.verifier_only.constants_sigmas_cap == \
        [tuple(int(x) for x in d)
         for d in outer.verifier_only.constants_sigmas_cap]
    got, want = data.prover_only.generators, host.generators
    assert [type(g).__name__ for g in got] == [type(g).__name__ for g in want]
    for g, w in zip(got, want):
        gv = {k: v.id() if hasattr(v, "id") else v
              for k, v in vars(g).items() if k not in ("rng", "_deps")}
        wv = {k: v.id() if hasattr(v, "id") else v
              for k, v in vars(w).items() if k not in ("rng", "_deps")}
        assert gv == wv, type(g).__name__


def test_recursive_challenger_matches_native_challenger():
    """Observe targets, squeeze challenges in a circuit: the port's witness
    holds the native Challenger's challenges on the same values."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    values = [int(v) for v in RNG.integers(0, ORDER, 23, dtype=np.uint64)]
    ts = builder.add_virtual_targets(len(values))
    rc = RecursiveChallenger(builder)
    native = Challenger(CONFIGS["PoseidonGoldilocksConfig"].hasher)
    got, want = [], []
    for lo, hi, n in [(0, 4, 2), (4, 13, 3), (13, 14, 1), (14, 23, 2)]:
        rc.observe_elements(ts[lo:hi])
        native.observe_elements(values[lo:hi])
        got += rc.get_n_challenges(n) + [rc.get_extension_challenge()]
        want += native.get_n_challenges(n) + \
            [native.get_extension_challenge()]
    host = builder.build_host()
    pw = PartialWitness()
    for t, v in zip(ts, values):
        pw.set_target(t, v)
    witness = generate_partial_witness(pw, host, host.common)
    read = [tuple(witness.get(x) for x in c) if isinstance(c, ExtTarget)
            else witness.get(c) for c in got]
    assert read == want


def _gadgets(builder, ext_target):
    """One of each builder gadget the recursion adds, on inputs x, y and
    the extension targets u, v; returns (inputs, outputs)."""
    x, y = builder.add_virtual_target(), builder.add_virtual_target()
    u = builder.add_virtual_extension_target()
    v = builder.add_virtual_extension_target()
    bits = builder.split_le(x, 8)
    outs = [builder.sub(x, y), builder.mul_add(x, y, x),
            builder.mul_const(5, y), builder.add_const(x, 9),
            builder.square(y), builder.inverse(y), builder.two(),
            builder.select(bits[0], x, y), builder.is_equal(x, y),
            builder.is_equal(x, x), builder.le_sum(bits[:5]),
            builder.exp_from_bits(y, bits[:3]),
            builder.exp_from_bits_const_base(3, bits[:4]),
            builder.random_access(bits[1], [x, y, builder.one(), y])]
    outs += builder.hash_or_noop([x, y])
    outs += builder.hash_n_to_hash_no_pad([x, y, x, y, x])
    outs += builder.permute_swapped([x] * 12, bits[2])[:4]
    for e in (builder.inverse_extension(u), builder.div_extension(u, v),
              builder.frobenius_ext(u), builder.square_extension(v),
              builder.exp_u64_extension(u, 11),
              builder.select_ext(bits[3], u, v),
              builder.random_access_extension(bits[1], [u, v, u, v]),
              builder.interpolate_coset(2, y, [u, v, u, v], v)):
        assert isinstance(e, ext_target)
        outs += list(e)
    builder.assert_zero(builder.sub(x, x))
    builder.assert_one(builder.mul(y, builder.inverse(y)))
    for t in outs:
        builder.register_public_input(t)
    return [x, y, u[0], u[1], v[0], v[1]], outs


def test_builder_gadgets_match_jax():
    """The builder's arithmetic, hashing and gadget-mixin methods lay out
    the same rows, copy constraints and witness as the JAX builder's."""
    from plonky2_tpu.iop.target import ExtTarget as JExtTarget
    from plonky2_tpu.iop import target as jtarget
    from plonky2_tpu.gates.extension_gates import MulExtensionGate as JMul
    from plonky2_tpu_torch.gates.extension_gates import MulExtensionGate
    from plonky2_tpu_torch.iop import target

    values = [0xB7, 12345, 7, 8, 9, 10]       # x fits the 8 bits of split_le
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=SEED)
    ins, _ = _gadgets(builder, ExtTarget)
    builder.add_gate_to_gate_set(MulExtensionGate(3))
    host = builder.build_host()
    pw = PartialWitness()
    for t, val in zip(ins, values):
        pw.set_target(t, val)
    witness = generate_partial_witness(pw, host, host.common)

    jbuilder = JBuilder(JCircuitConfig.standard_recursion_config(),
                        seed=SEED)
    jins, _ = _gadgets(jbuilder, JExtTarget)
    jbuilder.add_gate_to_gate_set(JMul(3))
    jdata = jbuilder.build()
    jpw = JPartialWitness()
    for t, val in zip(jins, values):
        jpw.set_target(t, val)
    jwitness = jgenerate_partial_witness(jpw, jdata.prover_only,
                                         jdata.common)
    assert common_from(jdata.common) == host.common
    assert "MulExtensionGate { num_ops: 3 }" in \
        [g.id() for g in host.common.gates]
    np.testing.assert_array_equal(
        host.constants_sigmas[host.common.num_constants:],
        jdata.prover_only.sigmas)
    np.testing.assert_array_equal(witness.full_witness(),
                                  jwitness.full_witness())
    assert witness.as_list() == jwitness.values
    routed = host.common.config.num_routed_wires
    for t in [("v", 3), ("w", 2, 79), ("w", 2, 80), ("w", 5, 134)]:
        assert target.is_wire(t) == jtarget.is_wire(t)
        assert target.is_routable(t, routed) == jtarget.is_routable(t, routed)
