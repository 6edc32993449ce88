"""Dummy circuits and proofs (reference recursion/dummy_circuit.rs): a
NoopGate-padded circuit of a given degree with unconstrained public inputs
— the base proof of a recursion chain, and a circuit whose kernels run at
the full size of its degree. `dummy_circuit_for_common` lays out such a
circuit with the shape of a given CommonCircuitData; `dummy_proof_and_vk`
proves it while an outer circuit is built, and a generator writes that
proof into the outer circuit's witness (the base case of cyclic
recursion)."""

from __future__ import annotations

from ..hash.hashers import PoseidonGoldilocksConfig
from ..iop.generator import SimpleGenerator
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.circuit_data import CircuitData, CommonCircuitData
from ..plonk.config import CircuitConfig
from .targets import (
    add_virtual_proof_with_pis, add_virtual_verifier_data,
    set_proof_with_pis_target, set_verifier_data_target,
)


def dummy_circuit(config: CircuitConfig, degree_bits: int,
                  num_public_inputs: int, *, device="cuda",
                  gc=PoseidonGoldilocksConfig) -> tuple[CircuitData, list]:
    """Returns (data, pi_targets); the circuit is committed on `device`
    under the hasher config `gc`."""
    builder = CircuitBuilder(config)
    pis = builder.add_virtual_targets(num_public_inputs)
    builder.register_public_inputs(pis)
    data = builder.build(device=device, min_degree_bits=degree_bits, gc=gc)
    assert data.common.degree_bits == degree_bits, \
        f"dummy circuit degree {data.common.degree_bits} != {degree_bits}"
    return data, pis


def dummy_builder_for_common(common: CommonCircuitData
                             ) -> tuple[CircuitBuilder, list]:
    """The unbuilt dummy circuit for `common`: its public inputs and every
    gate of `common` in its gate set. Returns (builder, pi_targets); build
    it with `min_degree_bits=common.degree_bits`."""
    assert not common.config.zero_knowledge, \
        "Degree calculation can be off if zero-knowledge is on."
    builder = CircuitBuilder(common.config)
    pis = builder.add_virtual_targets(common.num_public_inputs)
    builder.register_public_inputs(pis)
    for gate in common.gates:
        builder.add_gate_to_gate_set(gate)
    return builder, pis


# (id(common), num_public_inputs, device) -> (common, data, pi_targets);
# the entry holds `common`, so its id is not reused while it is cached
_DUMMY_CACHE: dict = {}


def dummy_circuit_for_common(common: CommonCircuitData, *, device="cuda"
                             ) -> tuple[CircuitData, list]:
    """A circuit whose CommonCircuitData equals `common`, committed on
    `device` (reference: dummy_circuit.rs:90-122). Returns (data,
    pi_targets)."""
    key = (id(common), common.num_public_inputs, str(device))
    if key in _DUMMY_CACHE:
        return _DUMMY_CACHE[key][1:]
    builder, pis = dummy_builder_for_common(common)
    data = builder.build(device=device, min_degree_bits=common.degree_bits,
                         gc=common.gc)
    assert data.common.same_shape(common), \
        "dummy circuit does not match the goal CommonCircuitData"
    _DUMMY_CACHE[key] = (common, data, pis)
    return data, pis


def dummy_witness(pi_targets: list,
                  nonzero_public_inputs: dict[int, int] | None = None
                  ) -> PartialWitness:
    """The dummy circuit's inputs; unspecified public inputs are zero."""
    nonzero_public_inputs = nonzero_public_inputs or {}
    pw = PartialWitness()
    for i, t in enumerate(pi_targets):
        pw.set_target(t, nonzero_public_inputs.get(i, 0))
    return pw


def dummy_proof(data: CircuitData, pi_targets: list,
                nonzero_public_inputs: dict[int, int] | None = None):
    """Prove the dummy circuit; unspecified public inputs are zero."""
    return data.prove(dummy_witness(pi_targets, nonzero_public_inputs))


def cyclic_base_proof(common: CommonCircuitData, verifier_only,
                      nonzero_public_inputs: dict[int, int] | None = None,
                      *, device="cuda"):
    """The base proof of a cyclic chain: a proof of the dummy circuit for
    `common` whose last public inputs carry the cyclic circuit's verifier
    data (reference: dummy_circuit.rs:37-66)."""
    pis = dict(nonzero_public_inputs or {})
    cap_elements = common.config.fri_config.num_cap_elements
    start = common.num_public_inputs - 4 - 4 * cap_elements
    for j, v in enumerate(verifier_only.circuit_digest):
        pis[start + j] = int(v)
    for i in range(cap_elements):
        for j, v in enumerate(verifier_only.constants_sigmas_cap[i]):
            pis[start + 4 + 4 * i + j] = int(v)
    data, pi_targets = dummy_circuit_for_common(common, device=device)
    return dummy_proof(data, pi_targets, pis)


class _OutShim:
    """A PartialWitness-shaped collector of a generator's outputs."""

    def __init__(self, out):
        self.out = out

    def set_target(self, t, v):
        self.out.append((t, int(v)))


class DummyProofGenerator(SimpleGenerator):
    """Writes a dummy proof made at build time, and its verifier data, into
    a proof target and a verifier-data target (reference:
    dummy_circuit.rs:150-230). It depends on nothing, so the witness
    fixpoint runs it in its first pass."""

    def __init__(self, pt, proof_with_pis, vt, verifier_data):
        self.pt = pt
        self.proof_with_pis = proof_with_pis
        self.vt = vt
        self.verifier_data = verifier_data

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        shim = _OutShim(out)
        set_proof_with_pis_target(shim, self.pt, self.proof_with_pis)
        set_verifier_data_target(shim, self.vt, self.verifier_data)


def dummy_proof_and_vk(builder, common: CommonCircuitData, *,
                       device="cuda"):
    """Proof and verifier-data targets of `builder`, filled at prove time
    with a proof of the dummy circuit for `common` (reference:
    dummy_circuit.rs:124-148). That proof is made now, on `device`: the
    device of the outer circuit's build."""
    data, pi_targets = dummy_circuit_for_common(common, device=device)
    proof = dummy_proof(data, pi_targets)
    pt = add_virtual_proof_with_pis(builder, common)
    vt = add_virtual_verifier_data(builder, common.config.fri_config.cap_height)
    builder.add_simple_generator(
        DummyProofGenerator(pt, proof, vt, data.verifier_only))
    return pt, vt
