"""CircuitBuilder — the builder core (reference: plonk/circuit_builder.rs —
add_gate:445, connect:516, find_slot:786, blind_and_pad:884,
build:1045-1265) for non-ZK circuits: virtual targets, public inputs,
connect, constants, arithmetic, the hashing gadgets, the gadget mixins
(extension and misc for the recursive verifier; u32, lookups, BigUint,
nonnative, secp256k1 curve and EcGFp5 for the application crates), the
verifier data of a cyclic circuit, padding and `build()`.

`build()` runs in two steps: `build_host()` lays out the rows, constants,
selectors and sigmas, the representative map and the generators on the
host; `commit()` commits the constants and sigmas on a device, the GPU
unless the caller asks for another, and the circuit's proofs run there.
`build(gc=...)` picks the hasher config of the commitments and the
transcript (`hash/hashers.py` CONFIGS). The builder's numpy generator
(`seed`) fills the unused public-input-gate wires at prove time, in the
reference's order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np

from ..ecdsa.biguint import BigUintGadgets
from ..ecdsa.curve_gadgets import CurveGadgets
from ..ecdsa.nonnative import NonNativeGadgets
from ..ecgfp5.gadgets import Gfp5Gadgets
from ..field import goldilocks as gl
from ..field import reference as ref
from ..fri.oracle import PolynomialBatch
from ..gadgets.extension import ExtensionGadgets
from ..gadgets.misc import MiscGadgets
from ..gadgets.u32 import U32Gadgets
from ..gates.basic_gates import (
    ArithmeticGate, ConstantGate, NoopGate, PublicInputGate,
)
from ..gates.gate import UNUSED_SELECTOR, Gate
from ..gates.lookup_gates import LookupGadgets
from ..gates.poseidon_gate import PoseidonGate
from ..hash.hashers import PoseidonGoldilocksConfig, digest_to_elements
from ..hash.sponge import NUM_HASH_OUT_ELTS, SPONGE_RATE, W
from ..iop.generator import ConstantGenerator, RandomValueGenerator
from ..iop.target import virtual, wire
from ..utils.context_tree import ContextStack
from .circuit_data import (
    CircuitData, CommonCircuitData, ProverOnlyData, SelectorsInfo,
    VerifierOnlyData,
)
from .config import CircuitConfig
from .permutation import Forest


@dataclasses.dataclass
class HostCircuit:
    """A circuit laid out on the host, before its commitment: what
    `generate_partial_witness` needs (generators, representative map) and
    the values the commitment takes."""
    common: CommonCircuitData
    constants_sigmas: np.ndarray    # uint64 [num_constants + routed, degree]
    subgroup: np.ndarray            # uint64 [degree]
    representative_map: np.ndarray
    generators: list
    public_inputs: list


class CircuitBuilder(ExtensionGadgets, MiscGadgets, U32Gadgets,
                     LookupGadgets, BigUintGadgets, NonNativeGadgets,
                     CurveGadgets, Gfp5Gadgets):
    def __init__(self, config: CircuitConfig | None = None,
                 seed: int | None = None):
        self.config = config or CircuitConfig.standard_recursion_config()
        self.gate_instances: list[tuple[Gate, list[int]]] = []
        self.gate_types: dict[str, Gate] = {}
        self.copy_constraints: list[tuple] = []
        self.public_inputs: list = []
        self.virtual_target_count = 0
        self.constants_to_targets: dict[int, tuple] = {}
        self.targets_to_constants: dict[tuple, int] = {}
        self.constant_generators: list[ConstantGenerator] = []
        self.base_arithmetic_results: dict = {}
        self.current_slots: dict[str, dict[tuple, tuple[int, int]]] = {}
        self.generators: list = []
        self._rng = np.random.default_rng(seed)
        # cyclic recursion (reference: circuit_builder.rs:196-200): this
        # circuit's own verifier data among its public inputs, and the
        # CommonCircuitData its build must equal
        self.verifier_data_public_input = None
        self.goal_common_data = None
        self._context_stack = ContextStack()

    # -- targets --------------------------------------------------------------
    def add_virtual_target(self):
        t = virtual(self.virtual_target_count)
        self.virtual_target_count += 1
        return t

    def add_virtual_targets(self, n: int):
        return [self.add_virtual_target() for _ in range(n)]

    def register_public_input(self, t) -> None:
        self.public_inputs.append(t)

    def register_public_inputs(self, ts) -> None:
        self.public_inputs.extend(ts)

    # -- gates ----------------------------------------------------------------
    def num_gates(self) -> int:
        return len(self.gate_instances)

    # -- context attribution (reference: circuit_builder.rs:681-699,
    #    util/context_tree.rs; print_gate_counts :1003-1030) ---------------
    def push_context(self, name: str) -> None:
        self._context_stack.push(name, self.num_gates())

    def pop_context(self) -> None:
        self._context_stack.pop(self.num_gates())

    @contextlib.contextmanager
    def context(self, name: str):
        """`with builder.context("fri verifier"): ...`, the with_context!
        macro: the gates added inside count to the scope."""
        self.push_context(name)
        try:
            yield
        finally:
            self.pop_context()

    def gate_counts(self) -> dict[str, int]:
        """Instance count per gate type (reference: print_gate_counts)."""
        counts: dict[str, int] = {}
        for gate, _ in self.gate_instances:
            counts[gate.id()] = counts.get(gate.id(), 0) + 1
        return counts

    def print_gate_counts(self, min_delta: int = 1) -> str:
        """Print and return the instances of each gate type, most first,
        then the scopes owning at least `min_delta` gates."""
        lines = [f"{n} instances of {gid}"
                 for gid, n in sorted(self.gate_counts().items(),
                                      key=lambda kv: -kv[1])]
        ctx = self._context_stack.root.report(min_delta)
        report = "\n".join(lines + ([ctx] if ctx else []))
        print(report)
        return report

    def add_gate(self, gate: Gate, constants: list[int]) -> int:
        assert gate.num_wires() <= self.config.num_wires, \
            f"{gate.id()} needs {gate.num_wires()} wires"
        assert len(constants) <= gate.num_constants()
        constants = (list(constants)
                     + [0] * (gate.num_constants() - len(constants)))
        row = len(self.gate_instances)
        for const_idx, wire_idx in gate.extra_constant_wires():
            self.constant_generators.append(
                ConstantGenerator(row, const_idx, wire_idx, 0))
        self.gate_types.setdefault(gate.id(), gate)
        self.gate_instances.append((gate, constants))
        return row

    def add_gate_to_gate_set(self, gate: Gate) -> None:
        """Register a gate type in the selector set without an instance
        (reference: circuit_builder.rs add_gate_to_gate_set)."""
        self.gate_types.setdefault(gate.id(), gate)

    def add_verifier_data_public_inputs(self):
        """Register this circuit's own verifier data as its last public
        inputs, [..., circuit_digest (4), constants_sigmas_cap (4 * 2^h)]
        (reference: circuit_builder.rs:427-442); register no public input
        after it."""
        assert self.verifier_data_public_input is None, \
            "add_verifier_data_public_inputs only needs to be called once"
        from ..recursion.targets import add_virtual_verifier_data
        vd = add_virtual_verifier_data(self, self.config.fri_config.cap_height)
        self.register_public_inputs(vd.circuit_digest)
        for h in vd.constants_sigmas_cap:
            self.register_public_inputs(h)
        self.verifier_data_public_input = vd
        return vd

    def add_simple_generator(self, g) -> None:
        self.generators.append(g)

    def find_slot(self, gate: Gate, params: tuple, constants: list[int]):
        """Batched-op slot allocation (reference: circuit_builder.rs:786)."""
        slots = self.current_slots.setdefault(gate.id(), {})
        if params in slots:
            gate_idx, slot_idx = slots[params]
        else:
            gate_idx, slot_idx = self.add_gate(gate, constants), 0
        if slot_idx == gate.num_ops() - 1:
            slots.pop(params, None)
        else:
            slots[params] = (gate_idx, slot_idx + 1)
        return gate_idx, slot_idx

    def connect(self, x, y) -> None:
        self.copy_constraints.append((x, y))

    def assert_zero(self, x) -> None:
        self.connect(x, self.zero())

    def assert_one(self, x) -> None:
        self.connect(x, self.one())

    # -- constants and arithmetic ---------------------------------------------
    def constant(self, c: int):
        c %= ref.ORDER
        if c in self.constants_to_targets:
            return self.constants_to_targets[c]
        t = self.add_virtual_target()
        self.constants_to_targets[c] = t
        self.targets_to_constants[t] = c
        return t

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)

    def two(self):
        return self.constant(2)

    def target_as_constant(self, t):
        return self.targets_to_constants.get(t)

    def arithmetic(self, const_0: int, const_1: int, m0, m1, addend):
        """A target for const_0 * m0 * m1 + const_1 * addend."""
        const_0 %= ref.ORDER
        const_1 %= ref.ORDER
        known = [self.target_as_constant(t) for t in (m0, m1, addend)]
        if None not in known:
            c0, c1, ca = known
            return self.constant((const_0 * c0 % ref.ORDER * c1
                                  + const_1 * ca) % ref.ORDER)
        key = (const_0, const_1, m0, m1, addend)
        if key in self.base_arithmetic_results:
            return self.base_arithmetic_results[key]
        gate = ArithmeticGate.from_config(self.config)
        row, i = self.find_slot(gate, (const_0, const_1), [const_0, const_1])
        self.connect(m0, wire(row, gate.wire_multiplicand_0(i)))
        self.connect(m1, wire(row, gate.wire_multiplicand_1(i)))
        self.connect(addend, wire(row, gate.wire_addend(i)))
        out = wire(row, gate.wire_output(i))
        self.base_arithmetic_results[key] = out
        return out

    def add(self, a, b):
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a, b):
        return self.arithmetic(1, ref.ORDER - 1, a, self.one(), b)

    def mul(self, a, b):
        return self.arithmetic(1, 0, a, b, self.zero())

    def mul_add(self, a, b, c):
        return self.arithmetic(1, 1, a, b, c)

    def mul_const(self, c: int, a):
        return self.arithmetic(c, 0, a, self.one(), self.zero())

    def add_const(self, a, c: int):
        return self.arithmetic(1, c, a, self.one(), self.one())

    def square(self, a):
        return self.mul(a, a)

    def inverse(self, x):
        """x_inv with x * x_inv = 1 (x must be nonzero)."""
        x_inv = self.add_virtual_target()
        self.generators.append(_InverseGenerator(x, x_inv))
        self.assert_one(self.mul(x, x_inv))
        return x_inv

    # -- hashing gadgets (reference: hash/hashing.rs:18-64) -------------------
    def permute_swapped(self, inputs: list, swap):
        gate = PoseidonGate()
        row = self.add_gate(gate, [])
        self.connect(swap, wire(row, gate.WIRE_SWAP))
        for i in range(W):
            self.connect(inputs[i], wire(row, gate.wire_input(i)))
        return [wire(row, gate.wire_output(i)) for i in range(W)]

    def permute(self, inputs: list):
        return self.permute_swapped(inputs, self.zero())

    def hash_n_to_m_no_pad(self, inputs: list, num_outputs: int):
        state = [self.zero()] * W
        for start in range(0, len(inputs), SPONGE_RATE):
            chunk = inputs[start:start + SPONGE_RATE]
            state = self.permute(chunk + state[len(chunk):])
        outputs = []
        while True:
            for s in state[:SPONGE_RATE]:
                outputs.append(s)
                if len(outputs) == num_outputs:
                    return outputs
            state = self.permute(state)

    def hash_n_to_hash_no_pad(self, inputs: list):
        return self.hash_n_to_m_no_pad(inputs, NUM_HASH_OUT_ELTS)

    def hash_or_noop(self, inputs: list):
        if len(inputs) <= NUM_HASH_OUT_ELTS:
            return inputs + [self.zero()] * (NUM_HASH_OUT_ELTS - len(inputs))
        return self.hash_n_to_hash_no_pad(inputs)

    def public_inputs_hash_gadget(self, inputs: list):
        """Public inputs are always hashed, even when <= 4."""
        return self.hash_n_to_m_no_pad(inputs, NUM_HASH_OUT_ELTS)

    def _num_blinding_gates(self, degree_estimate: int) -> tuple[int, int]:
        """(regular, Z) blinding rows of a degree estimate (reference:
        circuit_builder.rs:839-858, D = 2): the values FRI opens."""
        d = 2
        degree_bits = degree_estimate.bit_length() - 1
        fri = self.config.fri_config
        arities = [1 << a for a in fri.reduction_strategy.reduction_arity_bits(
            degree_bits, fri.rate_bits, fri.cap_height, fri.num_query_rounds)]
        total_folding = sum(a - 1 for a in arities)
        final_coeffs = degree_estimate // math.prod(arities)
        fri_openings = fri.num_query_rounds * (
            1 + d * total_folding + d * final_coeffs)
        return d + fri_openings, 2 * d + fri_openings

    def _blind(self) -> None:
        """Zero-knowledge blinding rows (reference: circuit_builder.rs:
        863-940): a random row for each regular opening, and for each Z
        opening two rows whose routed wires are random and copy-constrained
        to each other. The random values come from the builder's `_rng` at
        witness time."""
        num_gates = len(self.gate_instances)
        degree_estimate = 1 << (num_gates - 1).bit_length()
        while True:
            regular, z = self._num_blinding_gates(degree_estimate)
            if num_gates + regular + 2 * z <= degree_estimate:
                break
            degree_estimate *= 2
        nw, nr = self.config.num_wires, self.config.num_routed_wires
        for _ in range(regular):
            row = self.add_gate(NoopGate(), [])
            for w in range(nw):
                self.generators.append(
                    RandomValueGenerator(wire(row, w), self._rng))
        for _ in range(z):
            g1 = self.add_gate(NoopGate(), [])
            g2 = self.add_gate(NoopGate(), [])
            for w in range(nr):
                self.generators.append(
                    RandomValueGenerator(wire(g1, w), self._rng))
                self.connect(wire(g1, w), wire(g2, w))

    def blind_and_pad(self, min_degree_bits: int | None = None) -> None:
        if self.config.zero_knowledge:
            self._blind()
        n = len(self.gate_instances)
        target = max(1 << (n - 1).bit_length(), 1 << (min_degree_bits or 0))
        for _ in range(target - n):
            self.add_gate(NoopGate(), [])

    # -- build ----------------------------------------------------------------
    def build(self, *, device="cuda", min_degree_bits: int | None = None,
              gc=PoseidonGoldilocksConfig) -> CircuitData:
        return commit(self.build_host(min_degree_bits=min_degree_bits, gc=gc),
                      device)

    def build_host(self, *, min_degree_bits: int | None = None,
                   gc=PoseidonGoldilocksConfig) -> HostCircuit:
        """The host part of `build()`: rows, selectors, constants, sigmas,
        the representative map and the generators; commits nothing."""
        config = self.config
        rate_bits = config.fri_config.rate_bits
        cap_height = config.fri_config.cap_height

        num_public_inputs = len(self.public_inputs)
        pi_hash = self.public_inputs_hash_gadget(list(self.public_inputs))
        pi_gate_obj = PublicInputGate()
        pi_gate = self.add_gate(pi_gate_obj, [])
        for h, w in zip(pi_hash, pi_gate_obj.wires_public_inputs_hash()):
            self.connect(h, wire(pi_gate, w))
        # randomize unused public-input-gate wires (circuit_builder.rs:1025)
        for col in range(4, config.num_wires):
            self.generators.append(
                RandomValueGenerator(wire(pi_gate, col), self._rng))

        # route each constant to a ConstantGate slot
        while len(self.constants_to_targets) > len(self.constant_generators):
            self.add_gate(ConstantGate(config.num_constants), [])
        for (c, t), cg in zip(sorted(self.constants_to_targets.items()),
                              self.constant_generators):
            self.gate_instances[cg.row][1][cg.constant_index] = c
            self.connect(wire(cg.row, cg.wire_index), t)
            cg.constant = c
            self.generators.append(cg)

        self.blind_and_pad(min_degree_bits)
        degree = len(self.gate_instances)
        degree_bits = degree.bit_length() - 1
        fri_params = config.fri_config.fri_params(degree_bits,
                                                  config.zero_knowledge)
        assert fri_params.total_arities <= \
            degree_bits + rate_bits - cap_height, \
            "FRI total reduction arity is too large."

        qdf = config.max_quotient_degree_factor
        gates = sorted(self.gate_types.values(),
                       key=lambda g: (g.degree(), g.id()))
        selector_values, selectors_info = _selector_polynomials(
            gates, self.gate_instances, qdf + 1)
        constant_cols = np.zeros((config.num_constants, degree),
                                 dtype=np.uint64)
        for row, (_, consts) in enumerate(self.gate_instances):
            for j, c in enumerate(consts):
                constant_cols[j, row] = c
        constant_vecs = np.concatenate([selector_values, constant_cols])

        subgroup = np.asarray(ref.two_adic_subgroup(degree_bits),
                              dtype=np.uint64)
        k_is = [ref.exp(ref.MULTIPLICATIVE_GROUP_GENERATOR, i)
                for i in range(config.num_routed_wires)]
        forest = Forest(config.num_wires, config.num_routed_wires, degree)
        forest.add_virtual(self.virtual_target_count)
        for x, y in self.copy_constraints:
            forest.merge(x, y)
        representative_map = forest.compress_paths()
        sigma_vecs = forest.sigma_vecs(k_is, subgroup)

        # generators per gate instance, dropping unused batched-op slots
        incomplete = {gate_idx: next_slot
                      for slots in self.current_slots.values()
                      for gate_idx, next_slot in slots.values()}
        generators = list(self.generators)
        for row, (gate, consts) in enumerate(self.gate_instances):
            gens = gate.generators(row, consts)
            if row in incomplete:
                gens = gens[:incomplete[row]]
            generators.extend(gens)

        common = CommonCircuitData(
            config=config,
            fri_params=fri_params,
            gates=gates,
            selectors_info=selectors_info,
            quotient_degree_factor=qdf,
            num_gate_constraints=max(g.num_constraints() for g in gates),
            num_constants=constant_vecs.shape[0],
            num_public_inputs=num_public_inputs,
            k_is=k_is,
            num_partial_products=(config.num_routed_wires + qdf - 1) // qdf
            - 1,
            gc=gc,
        )
        if self.goal_common_data is not None:
            assert common.same_shape(self.goal_common_data), \
                ("cyclic recursion: built CommonCircuitData does not match "
                 "the goal passed to conditionally_verify_cyclic_proof")
        return HostCircuit(
            common=common,
            constants_sigmas=np.concatenate([constant_vecs, sigma_vecs]),
            subgroup=subgroup,
            representative_map=representative_map, generators=generators,
            public_inputs=list(self.public_inputs))


def commit(host: HostCircuit, device) -> CircuitData:
    """The device part of `build()`: commits the constants and sigmas on
    `device` and derives the circuit digest from the cap."""
    common = host.common
    fri_config = common.config.fri_config
    hasher = common.gc.hasher
    constants_sigmas = PolynomialBatch.from_values(
        gl.from_u64(host.constants_sigmas, device), fri_config.rate_bits,
        fri_config.cap_height, hasher)
    cap = constants_sigmas.merkle_tree.cap_digests()
    # circuit digest (circuit_builder.rs:1200-1212): hash of the cap, the
    # padded hash of the (empty) domain separator and degree_bits, each
    # digest as its field elements (25 bytes under Keccak: 4 elements)
    digest_inputs = ([x for d in cap for x in digest_to_elements(d)]
                     + digest_to_elements(hasher.hash_pad_oracle([]))
                     + [common.degree_bits])
    circuit_digest = hasher.hash_no_pad_oracle(digest_inputs)
    prover_only = ProverOnlyData(
        generators=host.generators,
        constants_sigmas_commitment=constants_sigmas,
        sigmas=host.constants_sigmas[common.num_constants:],
        subgroup=host.subgroup,
        public_inputs=host.public_inputs,
        representative_map=host.representative_map,
        circuit_digest=circuit_digest,
    )
    verifier_only = VerifierOnlyData(constants_sigmas_cap=cap,
                                     circuit_digest=circuit_digest)
    return CircuitData(prover_only, verifier_only, common)


class _InverseGenerator:
    """Fills x_inv = 1/x (reference: gadgets/arithmetic.rs inverse)."""

    def __init__(self, x, x_inv):
        self.x, self.x_inv = x, x_inv

    def watch_list(self):
        return [self.x]

    def run(self, witness, out):
        if not witness.is_set(self.x):
            return False
        x = witness.get(self.x)
        out.append((self.x_inv, ref.inverse(x) if x else 0))
        return True


def _selector_polynomials(gates, instances, max_degree: int):
    """reference: gates/selectors.rs:103-190."""
    n = len(instances)
    num_gates = len(gates)
    index = {g.id(): i for i, g in enumerate(gates)}
    if gates[-1].degree() + num_gates - 1 <= max_degree:
        poly = np.asarray([index[g.id()] for g, _ in instances],
                          dtype=np.uint64)[None, :]
        return poly, SelectorsInfo(selector_indices=[0] * num_gates,
                                   groups=[range(0, num_gates)])
    assert gates[-1].degree() < max_degree, \
        f"{gates[-1].id()} has too high degree"
    groups = []
    start = 0
    while start < num_gates:
        size = 0
        while (start + size < num_gates
               and size + gates[start + size].degree() < max_degree):
            size += 1
        groups.append(range(start, start + size))
        start += size
    selector_indices = [next(gi for gi, r in enumerate(groups) if i in r)
                        for i in range(num_gates)]
    polys = np.full((len(groups), n), UNUSED_SELECTOR, dtype=np.uint64)
    for j, (g, _) in enumerate(instances):
        i = index[g.id()]
        polys[selector_indices[i], j] = i
    return polys, SelectorsInfo(selector_indices=selector_indices,
                                groups=groups)
