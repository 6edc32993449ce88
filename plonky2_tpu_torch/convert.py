"""Carry a circuit built by the JAX package over to the port.

`circuit_data_from_arrays` takes the built circuit's state as numpy arrays
and host objects — the constants/sigmas commitment (coefficients, Merkle
leaves and digest layers), sigmas, subgroup, representative map, circuit
digest, generators, public-input targets and the CommonCircuitData — and
returns the port's CircuitData on `device`. Nothing here imports JAX or the
JAX package: the caller does the JAX -> numpy step (GF.to_u64(),
MerkleTree.leaves_host(), ...), and the JAX objects are read by attribute
and rebuilt as the port's own: the config, FRI parameters and selectors
field by field, the gates from their ids, the hasher config from its name,
the generators from their class name and fields. Targets are plain tuples
in both packages.
"""

from __future__ import annotations

import re

import numpy as np

from .field import goldilocks as gl
from .fri.config import FriConfig, FriParams, FriReductionStrategy
from .fri.oracle import PolynomialBatch
from .gadgets.extension import _ExtInverseGenerator
from .gadgets.misc import _BaseSumGenerator, _EqualityGenerator
from .gates.basic_gates import (
    ArithmeticGate, ConstantGate, NoopGate, PublicInputGate,
    _ArithmeticOpGenerator,
)
from .gates.coset_interpolation_gate import (
    CosetInterpolationGate, _InterpolationGenerator,
)
from .gates.extension_gates import (
    ArithmeticExtensionGate, MulExtensionGate, ReducingExtensionGate,
    ReducingGate, _ArithmeticExtOpGenerator, _MulExtOpGenerator,
    _ReducingExtGenerator, _ReducingGenerator,
)
from .gates.misc_gates import (
    BaseSplitGenerator, BaseSumGate, ExponentiationGate, RandomAccessGate,
    _ExponentiationGenerator, _RandomAccessGenerator,
)
from .gates.poseidon_gate import PoseidonGate, PoseidonGenerator
from .hash.hashers import CONFIGS
from .hash.merkle import MerkleTree
from .iop.generator import ConstantGenerator, RandomValueGenerator
from .iop.target import ExtTarget
from .plonk.circuit_builder import _InverseGenerator
from .plonk.circuit_data import (
    CircuitData, CommonCircuitData, ProverOnlyData, SelectorsInfo,
    VerifierOnlyData,
)
from .plonk.config import CircuitConfig
from .utils.bits import log2_strict


# gate name -> constructor from the integer fields of its id, in order
_GATES = {
    "ArithmeticGate": ArithmeticGate,
    "ConstantGate": ConstantGate,
    "ArithmeticExtensionGate": ArithmeticExtensionGate,
    "MulExtensionGate": MulExtensionGate,
    "ReducingExtensionGate": ReducingExtensionGate,
    "ReducingGate": ReducingGate,
    "BaseSumGate": BaseSumGate,                 # num_limbs, Base
    "ExponentiationGate": ExponentiationGate,
    "RandomAccessGate": RandomAccessGate,       # bits, copies, extra consts
    "CosetInterpolationGate": CosetInterpolationGate.with_degree,
}


def gate_from_id(gate_id: str):
    """The port's gate for a gate id of the JAX package."""
    fixed = {g.id(): g for g in (NoopGate(), PublicInputGate(),
                                 PoseidonGate())}
    if gate_id in fixed:
        return fixed[gate_id]
    name = gate_id.split(" ", 1)[0]
    if name not in _GATES:
        raise NotImplementedError(f"gate not ported: {gate_id}")
    gate = _GATES[name](*(int(v) for v in
                          re.findall(r"\b\w+: (\d+)", gate_id)))
    if gate.id() != gate_id:
        raise NotImplementedError(f"gate not ported: {gate_id}")
    return gate


def _target(t):
    """A target of the JAX package: its tuple, an ExtTarget stays one."""
    return ExtTarget(*map(tuple, t)) if type(t).__name__ == "ExtTarget" \
        else tuple(t)


def generator_from(g):
    """The port's witness generator for a generator of the JAX package."""
    kind = type(g).__name__
    if kind == "ConstantGenerator":
        return ConstantGenerator(g.row, g.constant_index, g.wire_index,
                                 int(g.constant))
    if kind == "RandomValueGenerator":
        return RandomValueGenerator(tuple(g.target), g.rng)
    if kind == "_ArithmeticOpGenerator":
        return _ArithmeticOpGenerator(g.row, g.i, int(g.c0), int(g.c1))
    if kind == "PoseidonGenerator":
        return PoseidonGenerator(g.row)
    if kind == "_ArithmeticExtOpGenerator":
        return _ArithmeticExtOpGenerator(g.row, g.i, int(g.c0), int(g.c1))
    if kind == "_MulExtOpGenerator":
        return _MulExtOpGenerator(g.row, g.i, int(g.c0))
    if kind == "BaseSplitGenerator":
        return BaseSplitGenerator(g.row, g.num_limbs, g.base)
    if kind == "_RandomAccessGenerator":
        return _RandomAccessGenerator(g.row, gate_from_id(g.gate.id()),
                                      g.copy)
    by_gate = {"_ReducingExtGenerator": _ReducingExtGenerator,
               "_ReducingGenerator": _ReducingGenerator,
               "_ExponentiationGenerator": _ExponentiationGenerator,
               "_InterpolationGenerator": _InterpolationGenerator}
    if kind in by_gate:
        return by_gate[kind](g.row, gate_from_id(g.gate.id()))
    by_targets = {"_InverseGenerator": (_InverseGenerator, ("x", "x_inv")),
                  "_ExtInverseGenerator": (_ExtInverseGenerator,
                                           ("x", "x_inv")),
                  "_EqualityGenerator": (_EqualityGenerator,
                                         ("x", "y", "equal", "inv"))}
    if kind in by_targets:
        cls, fields = by_targets[kind]
        return cls(*(_target(getattr(g, f)) for f in fields))
    if kind == "DummyProofGenerator":
        # it holds a proof made by the JAX package at build time
        raise NotImplementedError(
            "generator not ported: DummyProofGenerator (a JAX-built cyclic "
            "or dummy-verifying circuit carries a JAX proof; build the "
            "circuit with the port instead)")
    if kind == "_BaseSumGenerator":
        return _BaseSumGenerator([tuple(b) for b in g.bits],
                                 tuple(g.sum_target))
    raise NotImplementedError(f"generator not ported: {kind}")


def config_from(c) -> CircuitConfig:
    f, s = c.fri_config, c.fri_config.reduction_strategy
    return CircuitConfig(
        num_wires=c.num_wires, num_routed_wires=c.num_routed_wires,
        num_constants=c.num_constants, num_challenges=c.num_challenges,
        zero_knowledge=c.zero_knowledge,
        max_quotient_degree_factor=c.max_quotient_degree_factor,
        fri_config=FriConfig(
            rate_bits=f.rate_bits, cap_height=f.cap_height,
            proof_of_work_bits=f.proof_of_work_bits,
            reduction_strategy=FriReductionStrategy(
                kind=s.kind, arity_bits=s.arity_bits,
                final_poly_bits=s.final_poly_bits),
            num_query_rounds=f.num_query_rounds))


def common_from(common) -> CommonCircuitData:
    """The port's CommonCircuitData for the JAX package's."""
    if common.gc.name not in CONFIGS:
        raise NotImplementedError(f"hasher config not ported: "
                                  f"{common.gc.name}")
    config = config_from(common.config)
    fp = common.fri_params
    si = common.selectors_info
    return CommonCircuitData(
        config=config,
        fri_params=FriParams(config=config.fri_config, hiding=fp.hiding,
                             degree_bits=fp.degree_bits,
                             reduction_arity_bits=tuple(
                                 fp.reduction_arity_bits)),
        gates=[gate_from_id(g.id()) for g in common.gates],
        selectors_info=SelectorsInfo(
            selector_indices=list(si.selector_indices),
            groups=[range(g.start, g.stop) for g in si.groups]),
        quotient_degree_factor=common.quotient_degree_factor,
        num_gate_constraints=common.num_gate_constraints,
        num_constants=common.num_constants,
        num_public_inputs=common.num_public_inputs,
        k_is=[int(k) for k in common.k_is],
        num_partial_products=common.num_partial_products,
        gc=CONFIGS[common.gc.name],
    )


def circuit_data_from_arrays(common, *, polynomials: np.ndarray,
                             leaves: np.ndarray, layers: list,
                             sigmas: np.ndarray, subgroup: np.ndarray,
                             representative_map: np.ndarray,
                             circuit_digest, generators: list,
                             public_inputs: list, device) -> CircuitData:
    """polynomials: uint64 [num_polys, degree] coefficients; leaves: uint64
    [lde_size, num_polys] in bit-reversed row order; layers: numpy digest
    layers, leaf layer first and cap last (uint64 [m, 4], or uint8 [m, 25]
    under Keccak), kept on the host for a host hasher; circuit_digest: 4
    ints, or bytes under Keccak."""
    port_common = common_from(common)
    cap_height = port_common.config.fri_config.cap_height
    hasher = port_common.gc.hasher
    tree = MerkleTree(gl.from_u64(leaves, device), cap_height, hasher,
                      layers=[gl.from_u64(l, device) if hasher.device
                              else np.asarray(l, dtype=hasher.digest_dtype)
                              for l in layers])
    commitment = PolynomialBatch(
        gl.from_u64(polynomials, device), tree,
        log2_strict(polynomials.shape[-1]),
        port_common.config.fri_config.rate_bits)
    digest = (tuple(int(x) for x in circuit_digest) if hasher.algebraic
              else bytes(circuit_digest))
    prover_only = ProverOnlyData(
        generators=[generator_from(g) for g in generators],
        constants_sigmas_commitment=commitment,
        sigmas=np.asarray(sigmas, dtype=np.uint64),
        subgroup=np.asarray(subgroup, dtype=np.uint64),
        public_inputs=[tuple(t) for t in public_inputs],
        representative_map=np.asarray(representative_map, dtype=np.int64),
        circuit_digest=digest,
    )
    verifier_only = VerifierOnlyData(constants_sigmas_cap=tree.cap_digests(),
                                     circuit_digest=digest)
    return CircuitData(prover_only, verifier_only, port_common)
