"""Cyclic recursion (IVC): a circuit that verifies a proof of itself
(reference: plonky2/src/recursion/cyclic_recursion.rs —
VerifierOnlyCircuitData::from_slice:20-45, VerifierCircuitTarget::from_slice
:65-90, conditionally_verify_cyclic_proof:103-155,
conditionally_verify_cyclic_proof_or_dummy:157-176,
check_cyclic_proof_verifier_data:180-200, and the test's
common_data_for_recursion:222-252).

The circuit's own verifier data (circuit digest, constants/sigmas cap) is
the last of its public inputs. Each step connects the inner proof's
embedded verifier data to its own, so every proof of the chain is checked
against one key, and a verifier checks that key against the real one on
the host. The base step verifies a dummy proof instead, chosen by a
boolean condition.
"""

from __future__ import annotations

from ..gates.basic_gates import ConstantGate
from ..hash.hashers import PoseidonGoldilocksConfig
from ..plonk.circuit_builder import CircuitBuilder
from .conditional import conditionally_verify_proof
from .dummy import dummy_proof_and_vk
from .targets import (
    ProofWithPublicInputsTarget, VerifierCircuitTarget,
    add_virtual_proof_with_pis, add_virtual_verifier_data,
)
from .verifier import verify_proof_circuit


def _vk_pi_layout(common):
    """(index of the first verifier-data public input, cap length)."""
    cap_len = common.config.fri_config.num_cap_elements
    n = common.num_public_inputs
    assert n >= 4 + 4 * cap_len, "Not enough public inputs"
    return n - 4 - 4 * cap_len, cap_len


def verifier_data_from_pi_targets(pi_targets: list, common
                                  ) -> VerifierCircuitTarget:
    """The verifier data among public-input targets: [..., circuit_digest
    (4), constants_sigmas_cap (4 * cap_len)]."""
    start, cap_len = _vk_pi_layout(common)
    digest = pi_targets[start:start + 4]
    cap = [pi_targets[start + 4 + 4 * i:start + 8 + 4 * i]
           for i in range(cap_len)]
    return VerifierCircuitTarget(constants_sigmas_cap=cap,
                                 circuit_digest=digest)


def verifier_data_from_public_inputs(public_inputs: list, common):
    """The same on values: (circuit_digest, constants_sigmas_cap)."""
    start, cap_len = _vk_pi_layout(common)
    digest = [int(x) for x in public_inputs[start:start + 4]]
    cap = [[int(x) for x in public_inputs[start + 4 + 4 * i
                                          :start + 8 + 4 * i]]
           for i in range(cap_len)]
    return digest, cap


def conditionally_verify_cyclic_proof(
        builder, condition, cyclic_proof_with_pis: ProofWithPublicInputsTarget,
        other_proof_with_pis: ProofWithPublicInputsTarget,
        other_verifier_data: VerifierCircuitTarget, common) -> None:
    """Where condition = 1, verify a proof of the circuit being built; else
    verify `other_proof_with_pis` under `other_verifier_data`. Call
    `builder.add_verifier_data_public_inputs()` first; a verifier of the
    result also runs `check_cyclic_proof_verifier_data`."""
    verifier_data = builder.verifier_data_public_input
    assert verifier_data is not None, \
        "Must call add_verifier_data_public_inputs before cyclic recursion"
    if builder.goal_common_data is not None:
        assert builder.goal_common_data.same_shape(common)
    else:
        builder.goal_common_data = common

    inner = verifier_data_from_pi_targets(cyclic_proof_with_pis.public_inputs,
                                          common)
    # every proof of the cycle carries the same verifier data
    for t, u in zip(inner.circuit_digest, verifier_data.circuit_digest):
        builder.connect(t, u)
    for h_t, h_u in zip(inner.constants_sigmas_cap,
                        verifier_data.constants_sigmas_cap):
        for t, u in zip(h_t, h_u):
            builder.connect(t, u)

    conditionally_verify_proof(builder, condition, cyclic_proof_with_pis,
                               verifier_data, other_proof_with_pis,
                               other_verifier_data, common)
    # every gate of the goal, used here or not
    for g in common.gates:
        builder.add_gate_to_gate_set(g)


def conditionally_verify_cyclic_proof_or_dummy(builder, condition,
                                               cyclic_proof_with_pis,
                                               common, *,
                                               device="cuda") -> None:
    """`conditionally_verify_cyclic_proof` whose other proof is a dummy
    proof for `common`, made now on `device`."""
    dummy_pt, dummy_vt = dummy_proof_and_vk(builder, common, device=device)
    conditionally_verify_cyclic_proof(builder, condition,
                                      cyclic_proof_with_pis, dummy_pt,
                                      dummy_vt, common)


def check_cyclic_proof_verifier_data(proof_with_pis, verifier_only,
                                     common) -> None:
    """On the host: the verifier data embedded in the proof's public inputs
    is the circuit's own."""
    digest, cap = verifier_data_from_public_inputs(
        proof_with_pis.public_inputs, common)
    assert digest == [int(x) for x in verifier_only.circuit_digest], \
        "cyclic proof: circuit digest mismatch"
    assert cap == [[int(x) for x in h]
                   for h in verifier_only.constants_sigmas_cap], \
        "cyclic proof: constants/sigmas cap mismatch"


def common_data_for_recursion(config, degree_bits: int, *,
                              gc=PoseidonGoldilocksConfig):
    """The CommonCircuitData of a cyclic circuit of degree 2^degree_bits
    under `config`: the verifier of the verifier of an empty circuit,
    padded with NoopGates, with ConstantGate in its gate set (the dummy
    circuit routes its constants through one). Its public-input count is
    the caller's to set. Host layout only (`build_host`), since
    CommonCircuitData does not depend on the commitment."""
    common = CircuitBuilder(config).build_host(gc=gc).common
    for last in (False, True):
        builder = CircuitBuilder(config)
        pt = add_virtual_proof_with_pis(builder, common)
        vt = add_virtual_verifier_data(builder, config.fri_config.cap_height)
        verify_proof_circuit(builder, pt, vt, common)
        if last:
            builder.add_gate_to_gate_set(ConstantGate(config.num_constants))
            min_degree_bits = degree_bits
        else:
            min_degree_bits = None
        common = builder.build_host(min_degree_bits=min_degree_bits,
                                    gc=gc).common
    assert common.degree_bits == degree_bits, \
        (f"the verifier circuit needs degree 2^{common.degree_bits}, more "
         f"than 2^{degree_bits}")
    return common
