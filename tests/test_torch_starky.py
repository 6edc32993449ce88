"""The port's STARK system (plonky2_tpu_torch/starky/) against the JAX
package's (plonky2_tpu/starky/), on the CPU.

The same seeded traces (tests/stark_circuits.py) go through both provers at
2^5 rows; the proofs must be equal field by field (caps, openings, FRI
commit caps, query proofs, final polynomial, PoW witness), each package's
verifier must accept the other's proofs (through convert.py's
`stark_proof_from`/`multi_proof_from`, and `_to_jax` here), and tampered
proofs are rejected. The logUp helper columns, the CTL partial sums, both
sum scans and the quotient chunks are held against JAX's functions
directly, and the STARK test harnesses and gate degree audit run on the
port's fixtures and gates. Tolerance: exact.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import stark_circuits as sc
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.fri import proof as jfri
from plonky2_tpu.fri.oracle import PolynomialBatch as JPolynomialBatch
from plonky2_tpu.gates import gate_testing as jgate_testing
from plonky2_tpu.hash import hashers as jhashers
from plonky2_tpu.starky import cross_table_lookup as jctl
from plonky2_tpu.starky import lookup as jlookup
from plonky2_tpu.starky import proof as jproof
from plonky2_tpu.starky import prover as jprover
from plonky2_tpu.starky import verifier as jverifier
from plonky2_tpu.starky.config import StarkConfig as JStarkConfig
from plonky2_tpu_torch.convert import multi_proof_from, stark_proof_from
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.gates import gate_testing
from plonky2_tpu_torch.hash.hashers import CONFIGS
from plonky2_tpu_torch.starky import cross_table_lookup as ctl
from plonky2_tpu_torch.starky import lookup
from plonky2_tpu_torch.starky.config import StarkConfig
from plonky2_tpu_torch.starky.fibonacci_stark import FibonacciStark
from plonky2_tpu_torch.starky.permutation_stark import PermutationStark
from plonky2_tpu_torch.starky.prover import (
    compute_quotient_polys, prove, prove_multi,
)
from plonky2_tpu_torch.starky.stark_testing import (
    assert_stark_eval_coherence, assert_stark_low_degree,
)
from plonky2_tpu_torch.starky.unconstrained_stark import UnconstrainedStark
from plonky2_tpu_torch.starky.verifier import verify_multi, verify_stark_proof

PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
ROWS = 1 << 5
P2 = "Poseidon2GoldilocksConfig"
POSEIDON = "PoseidonGoldilocksConfig"
CONFIG = StarkConfig.standard_fast_config()
JCONFIG = JStarkConfig.standard_fast_config()


def _system(pkg: str, case: str):
    """(stark, trace, public inputs) of a single-table case; "wide" is the
    wide fixture at 4 lanes."""
    if case == "fibonacci":
        return sc.fibonacci(pkg, ROWS)
    if case == "wide":
        return sc.wide_fibonacci(pkg, 4, ROWS)
    if case == "unconstrained":
        stark = sc._starky(pkg, "unconstrained_stark").UnconstrainedStark(ROWS)
        return stark, stark.generate_trace(3), []
    stark = sc._starky(pkg, "permutation_stark").PermutationStark()
    return stark, stark.generate_trace(7, ROWS), [7]


_CACHE = {}


def _proofs(case: str, gc: str):
    """(port stark, port proof, JAX stark, JAX proof), proved once."""
    key = (case, gc)
    if key not in _CACHE:
        stark, trace, pis = _system(PORT, case)
        jstark, jtrace, jpis = _system(JAX, case)
        np.testing.assert_array_equal(trace, jtrace)
        assert pis == jpis
        port = prove(stark, CONFIG, trace, pis, gc=CONFIGS[gc], device="cpu")
        jax_ = jprover.prove(jstark, JCONFIG, jtrace, jpis,
                             gc=getattr(jhashers, gc))
        _CACHE[key] = stark, port, jstark, jax_
    return _CACHE[key]


def _multi(mismatch: bool = False):
    """(port starks, port proof, JAX starks, JAX proof) of the CTL pair."""
    key = ("ctl", mismatch)
    if key not in _CACHE:
        starks, traces, ctls, pis = sc.ctl_system(PORT, ROWS, mismatch)
        jstarks, jtraces, jctls, _ = sc.ctl_system(JAX, ROWS, mismatch)
        port = prove_multi(starks, CONFIG, traces, ctls, pis, device="cpu")
        jax_ = jprover.prove_multi(jstarks, JCONFIG, jtraces, jctls, pis)
        _CACHE[key] = (starks, ctls), port, (jstarks, jctls), jax_
    return _CACHE[key]


def _plain(x):
    """A proof as nested lists and dicts of python ints (and bytes)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (bytes, type(None))):
        return x
    return int(x)


def _assert_equal(port, jax_):
    """Field by field, so a failure names the field."""
    got, want = _plain(port), _plain(stark_proof_from(jax_))
    assert got["public_inputs"] == want["public_inputs"]
    gp, wp = got["proof"], want["proof"]
    for name in ("trace_cap", "auxiliary_polys_cap", "quotient_polys_cap",
                 "openings"):
        assert gp[name] == wp[name], name
    gf, wf = gp["opening_proof"], wp["opening_proof"]
    for name in ("commit_phase_merkle_caps", "final_poly", "pow_witness"):
        assert gf[name] == wf[name], name
    assert len(gf["query_round_proofs"]) == len(wf["query_round_proofs"])
    for i, (g, w) in enumerate(zip(gf["query_round_proofs"],
                                   wf["query_round_proofs"])):
        assert g == w, f"query round {i}"


def _to_jax(p):
    """The JAX package's StarkProofWithPublicInputs for the port's."""
    fp, o = p.proof.opening_proof, p.proof.openings
    fri = jfri.FriProof(
        commit_phase_merkle_caps=fp.commit_phase_merkle_caps,
        query_round_proofs=[jfri.FriQueryRound(
            initial_trees_proof=jfri.FriInitialTreeProof(
                list(q.initial_trees_proof.evals_proofs)),
            steps=[jfri.FriQueryStep(s.evals, s.merkle_proof)
                   for s in q.steps]) for q in fp.query_round_proofs],
        final_poly=fp.final_poly, pow_witness=fp.pow_witness)
    return jproof.StarkProofWithPublicInputs(
        proof=jproof.StarkProof(
            trace_cap=p.proof.trace_cap,
            quotient_polys_cap=p.proof.quotient_polys_cap,
            openings=jproof.StarkOpeningSet(**dataclasses.asdict(o)),
            opening_proof=fri,
            auxiliary_polys_cap=p.proof.auxiliary_polys_cap),
        public_inputs=list(p.public_inputs))


SINGLE = [(case, gc) for case in ("fibonacci", "unconstrained", "permutation")
          for gc in (POSEIDON, P2)]
IDS = [f"{case}-{gc[:-len('GoldilocksConfig')]}" for case, gc in SINGLE]


@pytest.mark.parametrize("case,gc", SINGLE, ids=IDS)
def test_stark_proof_matches_jax(case, gc):
    _, port, _, jax_ = _proofs(case, gc)
    _assert_equal(port, jax_)


@pytest.mark.parametrize("case,gc", SINGLE, ids=IDS)
def test_each_verifier_accepts_the_others_proof(case, gc):
    stark, port, jstark, jax_ = _proofs(case, gc)
    verify_stark_proof(stark, port, CONFIG, gc=CONFIGS[gc])
    verify_stark_proof(stark, stark_proof_from(jax_), CONFIG, gc=CONFIGS[gc])
    jverifier.verify_stark_proof(jstark, _to_jax(port), JCONFIG,
                                 gc=getattr(jhashers, gc))


@pytest.mark.parametrize("case,gc", SINGLE, ids=IDS)
def test_port_verifier_rejects_tampered_proof(case, gc):
    """A flipped trace opening, and where the constraints read the public
    inputs (PermutationStark's do not) a changed one, fail the port's
    verifier."""
    stark, port, _, _ = _proofs(case, gc)
    bad = copy.deepcopy(port)
    v = bad.proof.openings.local_values[0]
    bad.proof.openings.local_values[0] = ((v[0] + 1) % sc.P, v[1])
    with pytest.raises(AssertionError):
        verify_stark_proof(stark, bad, CONFIG, gc=CONFIGS[gc])
    if case == "fibonacci":
        bad = copy.deepcopy(port)
        bad.public_inputs[-1] = (bad.public_inputs[-1] + 1) % sc.P
        with pytest.raises(AssertionError):
            verify_stark_proof(stark, bad, CONFIG, gc=CONFIGS[gc])


def test_wide_fixture_against_jax():
    """The wide fixture at 4 lanes x 2^5 rows: the same trace and public
    inputs in both packages, the port's trace cap equal to JAX's commit of
    it, and the port's proof accepted by JAX's verifier (whose constraint
    check at zeta runs JAX's build of the fixture); a changed public input
    is rejected by both. (A JAX prove of it is not made: XLA:CPU compiles
    its quotient program for minutes.)"""
    stark, trace, pis = _system(PORT, "wide")
    jstark, jtrace, jpis = _system(JAX, "wide")
    np.testing.assert_array_equal(trace, jtrace)
    assert pis == jpis and stark.COLUMNS == jstark.COLUMNS == 8
    proof = prove(stark, CONFIG, trace, pis, device="cpu")
    rb, ch = CONFIG.fri_config.rate_bits, CONFIG.fri_config.cap_height
    jtc = JPolynomialBatch.from_values(GF.from_u64(jtrace), rb, False, ch)
    assert _plain(proof.proof.trace_cap) == \
        _plain(jtc.merkle_tree.cap_digests())
    verify_stark_proof(stark, proof, CONFIG)
    jverifier.verify_stark_proof(jstark, _to_jax(proof), JCONFIG)
    bad = copy.deepcopy(proof)
    bad.public_inputs[5] = (bad.public_inputs[5] + 1) % sc.P
    with pytest.raises(AssertionError):
        verify_stark_proof(stark, bad, CONFIG)
    with pytest.raises(AssertionError):
        jverifier.verify_stark_proof(jstark, _to_jax(bad), JCONFIG)


def test_permutation_stark_rejects_non_permutation():
    stark = PermutationStark()
    trace = stark.generate_trace(7, ROWS)
    trace[0][3] = 12345       # no longer a permutation of column 1
    proof = prove(stark, CONFIG, trace, [7], device="cpu")
    with pytest.raises(AssertionError):
        verify_stark_proof(stark, proof, CONFIG)


def test_ctl_multi_proof_matches_jax():
    """The two-table CTL system: every table's proof field by field (its
    ctl_zs_first included), and the CTL challenges."""
    _, port, _, jax_ = _multi()
    assert port.ctl_challenges == [tuple(int(v) for v in c)
                                   for c in jax_.ctl_challenges]
    assert len(port.stark_proofs) == 2
    for p, j in zip(port.stark_proofs, jax_.stark_proofs):
        assert p.proof.openings.ctl_zs_first is not None
        _assert_equal(p, j)


def test_ctl_each_verifier_accepts_the_others_proof():
    (starks, ctls), port, (jstarks, jctls), jax_ = _multi()
    verify_multi(starks, port, CONFIG, ctls)
    verify_multi(starks, multi_proof_from(jax_), CONFIG, ctls)
    jmulti = jproof.MultiProof([_to_jax(p) for p in port.stark_proofs],
                               port.ctl_challenges)
    jverifier.verify_multi(jstarks, jmulti, JCONFIG, jctls)


def test_ctl_rejects_multiset_mismatch():
    (starks, ctls), port, _, jax_ = _multi(mismatch=True)
    with pytest.raises(AssertionError, match="Cross-table lookup"):
        verify_multi(starks, port, CONFIG, ctls)
    for p, j in zip(port.stark_proofs, jax_.stark_proofs):
        _assert_equal(p, j)
    t0, t1 = sc.ctl_traces(16)
    ctl.check_ctls([t0, t1], sc.ctls(PORT))
    with pytest.raises(AssertionError):
        ctl.check_ctls(list(sc.ctl_traces(16, mismatch=True)), sc.ctls(PORT))


@pytest.mark.parametrize("gc", ["KeccakGoldilocksConfig",
                                "PoseidonBN128GoldilocksConfig"])
def test_outer_config_stark_proves_and_verifies(gc):
    """Byte digests (Keccak) and BN128 digests in the caps and transcript;
    the trees and the PoW grind on the host."""
    stark, trace, pis = sc.fibonacci(PORT, ROWS)
    proof = prove(stark, CONFIG, trace, pis, gc=CONFIGS[gc], device="cpu")
    assert isinstance(proof.proof.trace_cap[0],
                      bytes if gc.startswith("Keccak") else tuple)
    verify_stark_proof(stark, proof, CONFIG, gc=CONFIGS[gc])
    bad = copy.deepcopy(proof)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % sc.P
    with pytest.raises(AssertionError):
        verify_stark_proof(stark, bad, CONFIG, gc=CONFIGS[gc])


# --- helper columns, partial sums, scans, quotient ---------------------------

def _trace(rows: int, seed: int):
    """[5, rows]: three random columns, then two 0/1 filter columns."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, sc.P, size=(5, rows), dtype=np.uint64)
    t[3:] = rng.integers(0, 2, size=(2, rows), dtype=np.uint64)
    return t


def _lookups(pkg: str):
    lk = sc._starky(pkg, "lookup")
    col, filt = lk.Column, lk.Filter
    return [
        lk.Lookup(columns=(col.single(0),), table_column=col.single(1),
                  frequencies_column=col.single(2)),
        lk.Lookup(columns=(col.single(0), col.linear_combination(
            [(1, 3), (2, (1 << 40) + 5)]), col.single_next_row(2)),
            table_column=col.linear_combination_with_constant([(1, 7)], 9),
            frequencies_column=col.single(2),
            filter_columns=(filt.new_simple(col.single(3)), None,
                            filt(products=((col.single(3), col.single(4)),)))),
    ]


@pytest.mark.parametrize("rows", [1 << 5, 1 << 10])
@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("which", [0, 1])
def test_lookup_helper_columns_match_jax(rows, degree, which):
    t = _trace(rows, rows + degree)
    beta = 0xDEADBEEF12345 % sc.P
    got = lookup.lookup_helper_columns(_lookups(PORT)[which],
                                       gl.from_u64(t, "cpu"), beta, degree)
    want = jlookup.lookup_helper_columns(_lookups(JAX)[which],
                                         GF.from_u64(t), GF.const(beta),
                                         degree)
    np.testing.assert_array_equal(gl.to_u64(got), want.to_u64())


@pytest.mark.parametrize("rows", [1 << 5, 1 << 10])
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_ctl_partial_sums_match_jax(rows, groups):
    """One to three (columns, filter) groups, filtered rows included."""
    t = _trace(rows, rows + groups)

    def cfs(pkg):
        lk = sc._starky(pkg, "lookup")
        col, filt = lk.Column, lk.Filter
        all_ = [((col.single(0), col.single(1)), None),
                ((col.single(2), col.single_next_row(0)),
                 filt.new_simple(col.single(3))),
                ((col.linear_combination([(1, 2), (0, 3)]), col.single(2)),
                 filt(products=((col.single(3), col.single(4)),)))]
        return all_[:groups]

    beta, gamma = 0x1234567890ABCDEF % sc.P, 77
    got = ctl.partial_sums(gl.from_u64(t, "cpu"), cfs(PORT), beta, gamma, 3)
    want = jctl.partial_sums(GF.from_u64(t), cfs(JAX), GF.const(beta),
                             GF.const(gamma), 3)
    np.testing.assert_array_equal(gl.to_u64(got), want.to_u64())


@pytest.mark.parametrize("rows", [1 << 5, 1 << 10])
def test_sum_scans_match_jax(rows):
    """The logUp exclusive prefix sum and the CTL suffix sum, on random
    values and on rows of p - 1 (the largest sums)."""
    rng = np.random.default_rng(rows)
    x = np.concatenate([rng.integers(0, sc.P, size=(3, rows), dtype=np.uint64),
                        np.full((2, rows), sc.P - 1, dtype=np.uint64)])
    xt = gl.from_u64(x, "cpu")
    np.testing.assert_array_equal(
        gl.to_u64(lookup.cumsum_exclusive(xt)),
        jlookup._gf_cumsum_exclusive(GF.from_u64(x)).to_u64())
    np.testing.assert_array_equal(
        gl.to_u64(gl.suffix_sum(xt)),
        jctl._gf_suffix_cumsum(GF.from_u64(x)).to_u64())


@pytest.mark.parametrize("case", ["fibonacci", "permutation"])
def test_quotient_chunks_match_jax(case):
    """compute_quotient_polys on the same commitments and challenges."""
    stark, trace, pis = _system(PORT, case)
    jstark, _, _ = _system(JAX, case)
    rb, ch = CONFIG.fri_config.rate_bits, CONFIG.fri_config.cap_height
    alphas = [0x0123456789 % sc.P, (1 << 63) + 5]
    tc = PolynomialBatch.from_values(gl.from_u64(trace, "cpu"), rb, ch,
                                     CONFIGS[POSEIDON].hasher)
    jtc = JPolynomialBatch.from_values(GF.from_u64(trace), rb, False, ch)
    aux = jaux = betas = None
    if case == "permutation":
        betas = [11, 13]
        cols = [lookup.lookup_helper_columns(lk, gl.from_u64(trace, "cpu"), b,
                                             stark.constraint_degree())
                for lk in stark.lookups() for b in betas]
        aux = PolynomialBatch.from_values(torch.cat(cols), rb, ch,
                                          CONFIGS[POSEIDON].hasher)
        jcols = jprover._helper_columns_fn(jstark, JCONFIG, 5)(
            GF.from_u64(trace), GF.from_u64(np.asarray(betas,
                                                       dtype=np.uint64)))
        jaux = JPolynomialBatch.from_values(jcols, rb, False, ch)
    got = compute_quotient_polys(stark, CONFIG, tc, aux, betas, None, None,
                                 0, pis, alphas, 5)
    want = jprover._compute_quotient_polys(jstark, JCONFIG, jtc, jaux, betas,
                                           None, None, 0, pis, alphas, 5)
    np.testing.assert_array_equal(gl.to_u64(got), want.to_u64())


# --- harnesses ----------------------------------------------------------------

HARNESS_STARKS = [FibonacciStark(32), PermutationStark(), UnconstrainedStark(32),
                  sc.wide_fibonacci_stark_class(PORT)(3, 32)]


@pytest.mark.parametrize("stark", HARNESS_STARKS,
                         ids=lambda s: type(s).__name__)
def test_stark_harnesses(stark):
    assert_stark_low_degree(stark)
    assert_stark_eval_coherence(stark)


def test_degree_audit_catches_underdeclared_degree():
    class LyingStark(FibonacciStark):
        def eval(self, alg, frame, consumer):
            x = frame.local_values[0]
            # a degree-3 constraint under a declared degree of 2
            consumer.constraint(alg.mul(alg.mul(x, x), x))

    with pytest.raises(AssertionError, match="degree too high"):
        assert_stark_low_degree(LyingStark(32))


def _gates(pkg: str):
    """A gate of each kind the recursive STARK verifier lays out, and
    others, in both packages."""
    import importlib
    mod = lambda n: importlib.import_module(f"{pkg}.gates.{n}")
    cfg = importlib.import_module(f"{pkg}.plonk.config").CircuitConfig \
        .standard_recursion_config()
    basic, ext, misc = mod("basic_gates"), mod("extension_gates"), \
        mod("misc_gates")
    return [basic.ArithmeticGate.from_config(cfg),
            basic.ConstantGate(cfg.num_constants), basic.NoopGate(),
            ext.ArithmeticExtensionGate(10), ext.MulExtensionGate(13),
            ext.ReducingExtensionGate(8), ext.ReducingGate(9),
            misc.BaseSumGate(20, base=2), misc.ExponentiationGate(9),
            misc.RandomAccessGate(4, 4, 2),
            mod("coset_interpolation_gate").CosetInterpolationGate(4, 6)]


@pytest.mark.parametrize("i", range(11))
def test_gate_measured_degrees_match_jax(i):
    gate, jgate = _gates(PORT)[i], _gates(JAX)[i]
    assert gate.id() == jgate.id()
    got = gate_testing.measured_constraint_degrees(gate)
    assert got == jgate_testing.measured_constraint_degrees(jgate)
    gate_testing.assert_low_degree(gate)
