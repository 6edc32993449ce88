"""Gate-count attribution (`utils/context_tree.py`, the builder's
push_context / pop_context / context / gate_counts / print_gate_counts) and
the okx fork's circom and Solidity export (`utils/circom_export.py`, the
gates' export_*_verification_code) in the port, against the JAX package:
every report and every exported program string-equal to JAX's, for every
gate type of the fib(100) circuit and of its recursive wrap, and the
exported vanishing verifier run on the port's fib(100) proof
(tests/test_circom_verifier_loop.py): it accepts the proof and rejects a
tampered opening. Last, the small public methods the port lacked, against
JAX's: PartialWitness.set_targets, PartitionWitness.try_get,
Challenger.compact and get_n_extension_challenges, log2_ceil,
mul_poly_by_x, and TimingTree.print."""

import pytest

from plonky2_tpu.gates.basic_gates import NoopGate as JNoopGate
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.recursion import targets as jtargets
from plonky2_tpu.recursion.verifier import \
    verify_proof_circuit as jverify_proof_circuit
from plonky2_tpu.utils import circom_export as jcircom
from plonky2_tpu_torch.convert import gate_from
from plonky2_tpu_torch.field import reference as ref
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.get_challenges import get_challenges
from plonky2_tpu_torch.recursion.verifier import wrap_circuit
from plonky2_tpu_torch.utils import circom_export as circom

SEED = 1234


def _scoped(builder_cls, config_cls):
    """tests/test_context_tree.py's circuit: two scopes, one nested, one
    re-entered."""
    builder = builder_cls(config_cls.standard_recursion_config())
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    with builder.context("adds"):
        cur = a
        for _ in range(25):      # 20 ops an ArithmeticGate row: 2 rows
            cur = builder.add(cur, b)
    with builder.context("hash"):
        with builder.context("inner"):
            builder.hash_n_to_hash_no_pad([a, b, cur])
    for _ in range(2):
        builder.push_context("scope")
        for _ in range(21):
            cur = builder.add(cur, b)
        builder.pop_context()
    return builder


def test_print_gate_counts_matches_jax(capsys):
    port = _scoped(CircuitBuilder, CircuitConfig)
    jax = _scoped(JBuilder, JCircuitConfig)
    assert port.gate_counts() == jax.gate_counts()
    reports = {}
    for min_delta in (1, 2, 3):
        want = jax.print_gate_counts(min_delta)
        reports[min_delta] = port.print_gate_counts(min_delta)
        assert reports[min_delta] == want
        assert capsys.readouterr().out == 2 * (want + "\n")
    assert "2 gates to adds" in reports[1]
    assert "2 gates to adds" not in reports[3]
    got, want = (b._context_stack.root.children["scope"].gate_count
                 for b in (port, jax))
    assert got == want >= 2


def _fib(builder_cls, config_cls):
    builder = builder_cls(config_cls.standard_recursion_config(), seed=SEED)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    return builder, a, b


@pytest.fixture(scope="module")
def circuits():
    """The port's fib(100) data and proof (CPU), JAX's fib(100) data
    (built, never proved), and the gate types of both packages' wraps of
    it: the port's from its wrap's host layout, JAX's from its builder
    before build() (the gates build() adds are those of fib(100) and the
    padding's NoopGate)."""
    builder, a, b = _fib(CircuitBuilder, CircuitConfig)
    data = builder.build(device="cpu")
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    proof = data.prove(pw)
    jdata = _fib(JBuilder, JCircuitConfig)[0].build()

    wrap, _ = wrap_circuit(data)
    jwrap = JBuilder(JCircuitConfig.standard_recursion_config(), seed=SEED)
    pt = jtargets.add_virtual_proof_with_pis(jwrap, jdata.common)
    vt = jtargets.add_virtual_verifier_data(jwrap, 4)
    jverify_proof_circuit(jwrap, pt, vt, jdata.common)
    reports = (wrap.print_gate_counts(), jwrap.print_gate_counts())
    wrap_gates = wrap.build_host().common.gates
    jgates = {g.id(): g for g in jdata.common.gates}
    jgates.update(jwrap.gate_types)
    jgates[JNoopGate().id()] = JNoopGate()
    assert {g.id() for g in data.common.gates} <= set(jgates)
    assert {g.id() for g in wrap_gates} <= set(jgates)
    return data, proof, jdata, jgates, reports


def test_wrap_gate_counts_match_jax(circuits):
    """The recursive wrap of fib(100), laid out by both packages: the same
    gate report, string for string."""
    got, want = circuits[4]
    assert got == want
    assert "instances of PoseidonGate" in got


def test_every_gate_type_is_covered(circuits):
    ids = set(circuits[3])
    for name in ("NoopGate", "ArithmeticGate", "PoseidonGate", "ConstantGate",
                 "PublicInputGate", "RandomAccessGate",
                 "ArithmeticExtensionGate", "MulExtensionGate",
                 "ReducingGate", "BaseSumGate"):
        assert any(i.startswith(name) for i in ids), name


@pytest.mark.parametrize("kind", ["circom", "solidity"])
def test_gate_exports_match_jax(circuits, kind):
    """Each gate type of fib(100) and of its wrap: the port's gate (the
    same id) exports JAX's program, string for string."""
    jgates = circuits[3]
    for gate_id, jgate in sorted(jgates.items()):
        gate = gate_from(jgate)
        assert gate.id() == gate_id
        method = f"export_{kind}_verification_code"
        got = getattr(gate, method)()
        assert got == getattr(jgate, method)(), gate_id
        assert ("template" if kind == "circom" else "library") in got


def test_vanishing_verifier_export_matches_jax(circuits):
    data, _, jdata = circuits[:3]
    code = circom.export_vanishing_verifier_circom(data.common)
    assert code == jcircom.export_vanishing_verifier_circom(jdata.common)
    assert code.startswith("template VanishingAtZeta()")


def _run_exported(data, proof, tamper=None):
    """tests/test_circom_verifier_loop.py's check, with the port's
    challenges and proof: the exported program's out[i] against
    Z_H(zeta) t(zeta) from the quotient chunks."""
    common = data.common
    pi_hash = common.gc.hash_public_inputs(proof.public_inputs)
    ch = get_challenges(proof, pi_hash, data.verifier_only.circuit_digest,
                        common)
    zeta = tuple(ch.plonk_zeta)
    n = common.degree
    zeta_pow_n = ref.ext2_exp(zeta, n)
    z_h = ref.ext2_sub(zeta_pow_n, (1, 0))
    den = ref.ext2_scalar_mul(ref.ext2_sub(zeta, (1, 0)), n % ref.ORDER)
    l0 = ref.ext2_mul(z_h, ref.ext2_inverse(den))
    o = proof.proof.openings
    wires = [tuple(v) for v in o.wires]
    if tamper is not None:
        i, delta = tamper
        wires[i] = ((wires[i][0] + delta) % ref.ORDER, wires[i][1])
    outs = circom.evaluate_circom_program(
        circom.export_vanishing_verifier_circom(common), {
            "zeta": zeta, "l0": l0,
            "constants": [tuple(v) for v in o.constants],
            "wires": wires,
            "plonk_zs": [tuple(v) for v in o.plonk_zs],
            "plonk_zs_next": [tuple(v) for v in o.plonk_zs_next],
            "partial_products": [tuple(v) for v in o.partial_products],
            "sigmas": [tuple(v) for v in o.plonk_sigmas],
            "betas": [(int(b), 0) for b in ch.plonk_betas],
            "gammas": [(int(g), 0) for g in ch.plonk_gammas],
            "alphas": [(int(a), 0) for a in ch.plonk_alphas],
            "public_input_hash": [int(h) for h in pi_hash]})
    qdf = common.quotient_degree_factor
    ok = []
    for i in range(common.config.num_challenges):
        acc = (0, 0)
        for cq in reversed(o.quotient_polys[i * qdf:(i + 1) * qdf]):
            acc = ref.ext2_add(ref.ext2_mul(acc, zeta_pow_n), tuple(cq))
        ok.append(tuple(outs[i]) == tuple(ref.ext2_mul(z_h, acc)))
    return ok


def test_exported_verifier_accepts_port_proof(circuits):
    data, proof = circuits[:2]
    assert all(_run_exported(data, proof))


def test_exported_verifier_rejects_tampered_opening(circuits):
    data, proof = circuits[:2]
    assert not all(_run_exported(data, proof, tamper=(0, 1)))


def test_small_methods_match_jax():
    import numpy as np
    import torch

    from plonky2_tpu.field.extension import GF2 as JGF2
    from plonky2_tpu.field.goldilocks import GF
    from plonky2_tpu.hash.hashers import POSEIDON as JPOSEIDON
    from plonky2_tpu.iop.challenger import Challenger as JChallenger
    from plonky2_tpu.iop.witness import PartialWitness as JPartialWitness
    from plonky2_tpu.iop.witness import PartitionWitness as JPartition
    from plonky2_tpu.ops.polynomial import mul_poly_by_x as jmul_poly_by_x
    from plonky2_tpu.utils.bits import log2_ceil as jlog2_ceil
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.field.extension import GF2
    from plonky2_tpu_torch.hash.hashers import POSEIDON
    from plonky2_tpu_torch.iop.challenger import Challenger
    from plonky2_tpu_torch.iop.target import wire
    from plonky2_tpu_torch.iop.witness import PartitionWitness
    from plonky2_tpu_torch.ops.polynomial import mul_poly_by_x
    from plonky2_tpu_torch.utils.bits import log2_ceil
    from plonky2_tpu_torch.utils.timing import TimingTree

    assert [log2_ceil(n) for n in range(70)] == \
        [jlog2_ceil(n) for n in range(70)]

    pairs = [(("v", 3), 5), (("v", 4), ref.ORDER + 2)]
    pw, jpw = PartialWitness(), JPartialWitness()
    pw.set_targets(pairs)
    jpw.set_targets(pairs)
    assert pw.values == jpw.values

    rep = np.arange(8, dtype=np.int64)
    part, jpart = PartitionWitness(rep, 2, 4), JPartition(rep, 2, 4)
    for w in (part, jpart):
        w.set(wire(1, 0), 9)
    for t in (wire(1, 0), wire(2, 1)):
        assert part.try_get(t) == jpart.try_get(t)
    assert part.try_get(wire(2, 1)) is None

    ch, jch = Challenger(POSEIDON), JChallenger(JPOSEIDON)
    for c in (ch, jch):
        c.observe_elements([1, 2, 3])
    assert ch.get_n_extension_challenges(3) == \
        [tuple(x) for x in jch.get_n_extension_challenges(3)]
    for c in (ch, jch):
        c.observe_elements(range(5))
    assert ch.compact() == [int(x) for x in jch.compact()]
    assert ch.get_challenge() == jch.get_challenge()

    rng = np.random.default_rng(4)
    c0, c1 = (rng.integers(0, ref.ORDER, size=8, dtype=np.uint64)
              for _ in range(2))
    got = mul_poly_by_x(GF2(gl.from_u64(c0, "cpu"), gl.from_u64(c1, "cpu")))
    want = jmul_poly_by_x(JGF2(GF.from_u64(c0), GF.from_u64(c1)))
    np.testing.assert_array_equal(gl.to_u64(got.c0), want.c0.to_u64())
    np.testing.assert_array_equal(gl.to_u64(got.c1), want.c1.to_u64())

    timing = TimingTree("prove", enabled=True)
    with timing.scope("outer"):
        with timing.scope("inner"):
            torch.zeros(1)
    text = timing.print().splitlines()
    assert text[0] == "prove"
    assert text[1].endswith(" ms  outer") and text[2].endswith(" ms  inner")
    assert text[2].index("ms") > text[1].index("ms")
