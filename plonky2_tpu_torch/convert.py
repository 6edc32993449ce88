"""Carry a circuit built by the JAX package over to the port.

`circuit_data_from_arrays` takes the built circuit's state as numpy arrays
and host objects — the constants/sigmas commitment (coefficients, Merkle
leaves and digest layers), sigmas, subgroup, representative map, circuit
digest, generators, public-input targets and the CommonCircuitData — and
returns the port's CircuitData on `device`. Nothing here imports JAX or the
JAX package: the caller does the JAX -> numpy step (GF.to_u64(),
MerkleTree.leaves_host(), ...), and the JAX objects are read by attribute
and rebuilt as the port's own: the config, FRI parameters and selectors
field by field, the gates from their ids (a lookup gate's table from the
gate), the hasher config from its name, the generators from their class
name and fields (BigUint and nonnative targets rebuilt as the port's). Targets are plain tuples
in both packages.

`stark_proof_from` and `multi_proof_from` rebuild the port's STARK proof
containers from the JAX package's, the same way, by attribute name.
"""

from __future__ import annotations

import re

import numpy as np

from .ecdsa.biguint import BigUintTarget, _BigUintDivRemGenerator
from .ecdsa.curve_gadgets import _GlvDecompositionGenerator
from .ecdsa.nonnative import (
    NonNativeTarget, _NonNativeAdditionGenerator, _NonNativeInverseGenerator,
    _NonNativeMultiplicationGenerator, _NonNativeSubtractionGenerator,
)
from .ecgfp5.gadgets import (
    MulGFp5Gate, _MulGFp5Generator, _QuinticQuotientGenerator,
)
from .field import goldilocks as gl
from .fri.config import FriConfig, FriParams, FriReductionStrategy
from .fri.oracle import PolynomialBatch
from .fri.proof import (
    FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep,
)
from .gadgets.extension import _ExtInverseGenerator
from .gadgets.misc import _BaseSumGenerator, _EqualityGenerator
from .gadgets.u32 import (
    ComparisonGate, U32AddManyGate, U32ArithmeticGate, U32RangeCheckGate,
    U32SubtractionGate, _ComparisonGenerator, _U32AddManyGenerator,
    _U32ArithmeticGenerator, _U32RangeCheckGenerator,
    _U32SubtractionGenerator,
)
from .gates import interpolation_gates
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
from .gates.interpolation_gates import (
    HighDegreeInterpolationGate, LowDegreeInterpolationGate,
)
from .gates.lookup_gates import LookupGate, LookupTableGate, _LookupGenerator
from .gates.misc_gates import (
    BaseSplitGenerator, BaseSumGate, ExponentiationGate, PoseidonMdsGate,
    RandomAccessGate, _ExponentiationGenerator, _PoseidonMdsGenerator,
    _RandomAccessGenerator,
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
from .starky.proof import (
    MultiProof, StarkOpeningSet, StarkProof, StarkProofWithPublicInputs,
)
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
    "U32ArithmeticGate": U32ArithmeticGate,     # num_ops
    "U32AddManyGate": U32AddManyGate,           # num_addends, num_ops
    "U32SubtractionGate": U32SubtractionGate,
    "ComparisonGate": ComparisonGate,           # num_bits, num_chunks
    "U32RangeCheckGate": U32RangeCheckGate,
    "MulGFp5Gate": MulGFp5Gate,
    "HighDegreeInterpolationGate": HighDegreeInterpolationGate,
    "LowDegreeInterpolationGate": LowDegreeInterpolationGate,
}


def gate_from_id(gate_id: str):
    """The port's gate for a gate id of the JAX package."""
    fixed = {g.id(): g for g in (NoopGate(), PublicInputGate(),
                                 PoseidonGate(), PoseidonMdsGate())}
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


def gate_from(g):
    """The port's gate for a gate of the JAX package. A lookup gate's id
    holds only a hash of its table, so the table comes from the gate."""
    if type(g).__name__ == "LookupGate":
        gate = LookupGate(g.num_ops(), _lut(g.lut))
    elif type(g).__name__ == "LookupTableGate":
        gate = LookupTableGate(g.num_wires() // 3, _lut(g.lut),
                               g.last_lut_row)
    else:
        return gate_from_id(g.id())
    if gate.id() != g.id():
        raise NotImplementedError(f"gate not ported: {g.id()}")
    return gate


def _lut(pairs) -> tuple:
    """A table as a tuple of pairs of python ints (its hash is in the id)."""
    return tuple((int(a), int(b)) for a, b in pairs)


def _value(v):
    """A generator's field of the JAX package: a target stays its tuple (an
    ExtTarget stays one), BigUint and nonnative targets become the port's,
    lists and tuples of them convert element-wise, ints stay ints."""
    kind = type(v).__name__
    if kind == "ExtTarget":
        return ExtTarget(*map(tuple, v))
    if kind == "BigUintTarget":
        return BigUintTarget(_value(v.limbs))
    if kind == "NonNativeTarget":
        return NonNativeTarget(_value(v.value), int(v.modulus))
    if isinstance(v, list):
        return [_value(x) for x in v]
    if isinstance(v, tuple):
        return v if v and isinstance(v[0], str) else \
            tuple(_value(x) for x in v)
    return int(v)


# generator name -> (the port's class, its fields in constructor order)
_BY_FIELDS = {
    "_InverseGenerator": (_InverseGenerator, ("x", "x_inv")),
    "_ExtInverseGenerator": (_ExtInverseGenerator, ("x", "x_inv")),
    "_EqualityGenerator": (_EqualityGenerator, ("x", "y", "equal", "inv")),
    "_BaseSumGenerator": (_BaseSumGenerator, ("bits", "sum_target")),
    "_BigUintDivRemGenerator": (_BigUintDivRemGenerator,
                                ("a", "b", "div", "rem")),
    "_NonNativeAdditionGenerator": (_NonNativeAdditionGenerator,
                                    ("a", "b", "sum", "overflow")),
    "_NonNativeSubtractionGenerator": (_NonNativeSubtractionGenerator,
                                       ("a", "b", "diff", "overflow")),
    "_NonNativeMultiplicationGenerator": (_NonNativeMultiplicationGenerator,
                                          ("a", "b", "prod", "overflow")),
    "_NonNativeInverseGenerator": (_NonNativeInverseGenerator,
                                   ("x", "inv", "div")),
    "_GlvDecompositionGenerator": (_GlvDecompositionGenerator,
                                   ("k", "k1", "k2", "k1_neg", "k2_neg")),
    "_QuinticQuotientGenerator": (_QuinticQuotientGenerator,
                                  ("a", "b", "quotient")),
}
# generators of one op of a batched gate: (row, gate, op index)
_BY_OP = {"_U32ArithmeticGenerator": _U32ArithmeticGenerator,
          "_U32AddManyGenerator": _U32AddManyGenerator,
          "_U32SubtractionGenerator": _U32SubtractionGenerator}
# generators of a whole row: (row, gate)
_BY_GATE = {"_ReducingExtGenerator": _ReducingExtGenerator,
            "_ReducingGenerator": _ReducingGenerator,
            "_ExponentiationGenerator": _ExponentiationGenerator,
            "_ComparisonGenerator": _ComparisonGenerator,
            "_U32RangeCheckGenerator": _U32RangeCheckGenerator}


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
    if kind == "_PoseidonMdsGenerator":
        return _PoseidonMdsGenerator(g.row)
    if kind == "_ArithmeticExtOpGenerator":
        return _ArithmeticExtOpGenerator(g.row, g.i, int(g.c0), int(g.c1))
    if kind == "_MulExtOpGenerator":
        return _MulExtOpGenerator(g.row, g.i, int(g.c0))
    if kind == "BaseSplitGenerator":
        return BaseSplitGenerator(g.row, g.num_limbs, g.base)
    if kind == "_RandomAccessGenerator":
        return _RandomAccessGenerator(g.row, gate_from(g.gate), g.copy)
    if kind == "_MulGFp5Generator":
        return _MulGFp5Generator(g.row, gate_from(g.gate), g.i, int(g.c))
    if kind == "_LookupGenerator":
        return _LookupGenerator(g.row, g.slot,
                                {int(a): int(b) for a, b in g.table.items()})
    if kind == "_InterpolationGenerator" and hasattr(g, "low_degree"):
        # the legacy interpolation gates' (interpolation_gates.py)
        return interpolation_gates._InterpolationGenerator(
            g.row, gate_from(g.gate), g.low_degree)
    if kind == "_InterpolationGenerator":
        return _InterpolationGenerator(g.row, gate_from(g.gate))
    if kind in _BY_OP:
        return _BY_OP[kind](g.row, gate_from(g.gate), g.i)
    if kind in _BY_GATE:
        return _BY_GATE[kind](g.row, gate_from(g.gate))
    if kind in _BY_FIELDS:
        cls, fields = _BY_FIELDS[kind]
        return cls(*(_value(getattr(g, f)) for f in fields))
    if kind == "DummyProofGenerator":
        # it holds a proof made by the JAX package at build time
        raise NotImplementedError(
            "generator not ported: DummyProofGenerator (a JAX-built cyclic "
            "or dummy-verifying circuit carries a JAX proof; build the "
            "circuit with the port instead)")
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
                kind=s.kind, fixed=tuple(s.fixed), arity_bits=s.arity_bits,
                final_poly_bits=s.final_poly_bits,
                max_arity_bits=s.max_arity_bits),
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
        gates=[gate_from(g) for g in common.gates],
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


def _digest(d):
    """A host digest: bytes stay bytes, 4 elements become a tuple of ints."""
    if isinstance(d, (bytes, bytearray)):
        return bytes(d)
    return tuple(int(x) for x in d)


def _cap(cap):
    return None if cap is None else [_digest(d) for d in cap]


def _ext(v) -> tuple:
    return int(v[0]), int(v[1])


def _exts(vs):
    return None if vs is None else [_ext(v) for v in vs]


def fri_proof_from(fp) -> FriProof:
    """The port's FriProof for a FriProof of the JAX package."""
    return FriProof(
        commit_phase_merkle_caps=[_cap(c)
                                  for c in fp.commit_phase_merkle_caps],
        query_round_proofs=[FriQueryRound(
            initial_trees_proof=FriInitialTreeProof([
                (np.asarray(evals, dtype=np.uint64), np.asarray(path))
                for evals, path in q.initial_trees_proof.evals_proofs]),
            steps=[FriQueryStep(evals=_exts(s.evals),
                                merkle_proof=np.asarray(s.merkle_proof))
                   for s in q.steps])
            for q in fp.query_round_proofs],
        final_poly=_exts(fp.final_poly),
        pow_witness=int(fp.pow_witness))


def stark_proof_from(obj) -> StarkProofWithPublicInputs:
    """The port's StarkProofWithPublicInputs for the JAX package's."""
    p, o = obj.proof, obj.proof.openings
    return StarkProofWithPublicInputs(
        proof=StarkProof(
            trace_cap=_cap(p.trace_cap),
            quotient_polys_cap=_cap(p.quotient_polys_cap),
            openings=StarkOpeningSet(
                local_values=_exts(o.local_values),
                next_values=_exts(o.next_values),
                quotient_polys=_exts(o.quotient_polys),
                auxiliary_polys=_exts(o.auxiliary_polys),
                auxiliary_polys_next=_exts(o.auxiliary_polys_next),
                ctl_zs_first=(None if o.ctl_zs_first is None
                              else [int(v) for v in o.ctl_zs_first])),
            opening_proof=fri_proof_from(p.opening_proof),
            auxiliary_polys_cap=_cap(p.auxiliary_polys_cap)),
        public_inputs=[int(v) for v in obj.public_inputs])


def multi_proof_from(obj) -> MultiProof:
    """The port's MultiProof for the JAX package's."""
    return MultiProof(
        stark_proofs=[stark_proof_from(p) for p in obj.stark_proofs],
        ctl_challenges=[(int(b), int(g)) for b, g in obj.ctl_challenges])
