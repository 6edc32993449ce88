"""The port's recursive STARK verifier (plonky2_tpu_torch/starky/
recursive_verifier.py) against the JAX package's, on the CPU.

tests/stark_circuits.py's `stark_verifier_circuit` lays out the plonky2
circuit that verifies a STARK proof at 2^5 rows in both packages (the
port with `build_host()`, JAX with `build()`): FibonacciStark (the circuit
of tests/test_starky_recursive.py), PermutationStark (logUp constraints in
the circuit) and table 0 of the CTL pair (its CTL constraints, and its Z
opened at x = 1: a third FRI batch in the circuit). Both are filled from the
port's STARK proof; the gates, selectors, constants, sigmas and every wire
of the witness must be equal, and every row's constraints vanish on the
port's witness. A proof with a flipped FRI opening makes no witness.
Tolerance: exact.
"""

import copy

import numpy as np
import pytest
import torch

import stark_circuits as sc
from plonky2_tpu.iop.generator import \
    generate_partial_witness as jgenerate_partial_witness
from plonky2_tpu.iop.witness import PartialWitness as JPartialWitness
from plonky2_tpu.starky import recursive_verifier as jrv
from plonky2_tpu.starky.config import StarkConfig as JStarkConfig
from plonky2_tpu_torch.convert import common_from
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.plonk.vanishing import evaluate_gate_constraints_rows
from plonky2_tpu_torch.starky import recursive_verifier as rv
from plonky2_tpu_torch.starky.config import StarkConfig
from plonky2_tpu_torch.starky.prover import prove
from plonky2_tpu_torch.starky.verifier import verify_stark_proof
from test_torch_starky import _to_jax

PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
ROWS, DEGREE_BITS = 1 << 5, 5
CONFIG = StarkConfig.standard_fast_config()
JCONFIG = JStarkConfig.standard_fast_config()
CASES = ["fibonacci", "permutation", "ctl-table0"]

_CACHE = {}


def _stark_proof(pkg: str, case: str, config):
    """(stark, proof, ctl) in `pkg` (the JAX side is only laid out)."""
    if case == "ctl-table0":
        return sc.ctl_table0(pkg, ROWS, config)
    if case == "fibonacci":
        stark, trace, pis = sc.fibonacci(pkg, ROWS)
    else:
        stark = sc._starky(pkg, "permutation_stark").PermutationStark()
        trace, pis = stark.generate_trace(7, ROWS), [7]
    proof = prove(stark, config, trace, pis, device="cpu") \
        if pkg == PORT else None
    return stark, proof, None


def _circuits(case: str):
    """(port host circuit, port witness, proof targets, proof, JAX built
    circuit, JAX witness), built once."""
    if case not in _CACHE:
        stark, proof, ctl = _stark_proof(PORT, case, CONFIG)
        verify_stark_proof(stark, proof, CONFIG, ctl_challenges=(
            ctl[2] if ctl else None), ctls=ctl[0] if ctl else None)
        builder, pt = sc.stark_verifier_circuit(PORT, stark, CONFIG,
                                                DEGREE_BITS, ctl)
        host = builder.build_host()
        pw = PartialWitness()
        rv.set_stark_proof_with_pis_target(pw, pt, proof)
        witness = generate_partial_witness(pw, host, host.common)

        if case == "ctl-table0":
            jstark = sc.ctl_system(JAX, ROWS)[0][0]
            jctl = (sc.ctls(JAX),) + ctl[1:]
        else:
            jstark, _, jctl = _stark_proof(JAX, case, JCONFIG)
        jbuilder, jpt = sc.stark_verifier_circuit(JAX, jstark, JCONFIG,
                                                  DEGREE_BITS, jctl)
        outer = jbuilder.build()
        jpw = JPartialWitness()
        jrv.set_stark_proof_with_pis_target(jpw, jpt, _to_jax(proof))
        jwitness = jgenerate_partial_witness(jpw, outer.prover_only,
                                             outer.common)
        _CACHE[case] = host, witness, pt, proof, outer, jwitness
    return _CACHE[case]


@pytest.mark.parametrize("case", CASES)
def test_layout_matches_jax(case):
    """Gate ids, degree, selector groups, CommonCircuitData field by field,
    the constant rows (through the port's iNTT against JAX's committed
    coefficients), the sigmas and the representative map."""
    host, _, _, _, outer, _ = _circuits(case)
    common = host.common
    assert [g.id() for g in common.gates] == \
        [g.id() for g in outer.common.gates]
    assert common.degree_bits == outer.common.degree_bits
    assert common_from(outer.common) == common
    po = outer.prover_only
    nc = outer.common.num_constants
    np.testing.assert_array_equal(host.constants_sigmas[nc:], po.sigmas)
    np.testing.assert_array_equal(host.representative_map,
                                  po.representative_map)
    coeffs = ntt.ifft(gl.from_u64(host.constants_sigmas[:nc], "cpu"))
    np.testing.assert_array_equal(
        gl.to_u64(coeffs),
        po.constants_sigmas_commitment.polynomials.to_u64()[:nc])


@pytest.mark.parametrize("case", CASES)
def test_witness_matches_jax(case):
    """Every wire of the witness fixpoint and every target JAX sets; the
    public inputs are the STARK's."""
    host, witness, pt, proof, _, jwitness = _circuits(case)
    np.testing.assert_array_equal(witness.full_witness(),
                                  jwitness.full_witness())
    assert witness.as_list() == jwitness.values
    assert [witness.get(t) for t in host.public_inputs] == \
        list(proof.public_inputs)


@pytest.mark.parametrize("case", CASES)
def test_rows_vanish(case):
    """Every row's gate constraints vanish on the port's witness."""
    host, witness, _, _, _, _ = _circuits(case)
    common = host.common
    pis = [witness.get(t) for t in host.public_inputs]
    pi_hash = common.gc.hash_public_inputs(pis)
    out = evaluate_gate_constraints_rows(
        common,
        gl.from_u64(host.constants_sigmas[:common.num_constants], "cpu"),
        gl.from_u64(witness.full_witness(), "cpu"),
        gl.from_u64(np.tile(np.asarray(pi_hash, dtype=np.uint64)[:, None],
                            (1, common.degree)), "cpu"))
    bad = torch.nonzero(out.ne(0).any(0)).reshape(-1).tolist()
    assert not bad, f"rows with nonzero constraints: {bad[:10]}"


def test_flipped_fri_opening_makes_no_witness():
    """A trace value of one FRI query's initial opening flipped: the
    in-circuit Merkle check connects two different digests."""
    host, _, pt, proof, _, _ = _circuits("fibonacci")
    bad = copy.deepcopy(proof)
    evals = bad.proof.opening_proof.query_round_proofs[0] \
        .initial_trees_proof.evals_proofs[0][0]
    evals[0] = (int(evals[0]) + 1) % sc.P
    pw = PartialWitness()
    rv.set_stark_proof_with_pis_target(pw, pt, bad)
    with pytest.raises(AssertionError, match="set twice"):
        generate_partial_witness(pw, host, host.common)
