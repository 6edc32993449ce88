"""The benchmark's reference for recursion_wrap_d13 (benchmark/reference/
gates.py, recursion_wrap_d13.py) against the port and the JAX package, and
the witness fixpoint's spans and counters.

- Each gate type of the wrap: the reference's constraints equal the port's
  `eval_unfiltered` at random extension wires and constants.
- The pinned verifier key: the JAX package lays the wrap out through its
  own public recursion API and commits it; its cap and digest equal the
  pinned ones, and its layout (gates, selectors, constants, sigmas) equals
  the port's `build_host`, whose rows, public inputs and generators are
  those the configuration states. The pinned values were made by the
  reference's own commitment (`plain_torch.commitment_cap`) of that layout,
  which takes minutes here; on a card `benchmark/tests/test_bench_wrap.py`
  recomputes it.
- A small wrap proved on the CPU (the leaf at 2^6 with one FRI query, so the
  wrap is 2^11 rows; a prove takes minutes here, so the proofs are the
  golden files `tests/golden/wrap_small_*`) passes the reference's `check`,
  and is refused after one flipped opening and after one changed public
  input.
- One wrap's fixpoint under an enabled TimingTree opens the two spans and
  adds the two counters, whose counts are pinned, and its wire matrix
  counts every set representative.

Remake the golden files with `PYTHONPATH=. python
tests/test_bench_wrap_reference.py` (~3 min) whenever the wrap's layout or
the proof format changes. Tolerance: exact.
"""

import dataclasses
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import load  # noqa: E402
from benchmark.reference import recursion_wrap_d13 as ref_wrap  # noqa: E402
from benchmark.reference.field import P  # noqa: E402
from benchmark.run import _apply  # noqa: E402
from plonky2_tpu_torch.gates.gate import EXT  # noqa: E402
from plonky2_tpu_torch.iop.generator import \
    generate_partial_witness  # noqa: E402
from plonky2_tpu_torch.iop.witness import wire_matrix  # noqa: E402
from plonky2_tpu_torch.plonk.circuit_builder import \
    CircuitBuilder  # noqa: E402
from plonky2_tpu_torch.recursion.verifier import wrap_circuit  # noqa: E402
from plonky2_tpu_torch.utils import serialization  # noqa: E402
from plonky2_tpu_torch.utils.timing import TimingTree  # noqa: E402

CFG = load.data("configs", "recursion_wrap_d13")
LEAF = load.module("configs", "recursion_leaf_d14")
WRAP = load.module("configs", "recursion_wrap_d13")
GOLDEN = os.path.join(REPO, "tests", "golden")
SMALL_JSON = os.path.join(GOLDEN, "wrap_small.json")
SMALL_PROOF = os.path.join(GOLDEN, "wrap_small_proof.bin")
SMALL_INNER = os.path.join(GOLDEN, "wrap_small_inner_proof.bin")
# the configuration cut to a wrap the CPU proves: the leaf at 2^6 with one
# FRI query; the wrap keeps its own settings
SMALL = {"inner_config": {"degree_bits": 6, "fri": {"num_query_rounds": 1}},
         "degree_bits": 11}
SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


class _Inner:
    """What `wrap_circuit` reads of the inner circuit: its common data,
    here from the leaf's host layout (a 2^14 commitment is out of reach of
    this CPU, and the wrap's layout needs none)."""

    def __init__(self, common):
        self.common = common


_CACHE = {}


def port_wrap():
    """The port's leaf layout at 2^14 and its wrap's host circuit."""
    if "port" not in _CACHE:
        inner = CFG["inner_config"]
        builder = CircuitBuilder(LEAF.circuit_config(inner), seed=SEED)
        builder.register_public_inputs(
            builder.add_virtual_targets(inner["num_public_inputs"]))
        leaf = builder.build_host(min_degree_bits=inner["degree_bits"])
        wrap, _ = wrap_circuit(_Inner(leaf.common), register_inner=True,
                               config=LEAF.circuit_config(CFG))
        _CACHE["port"] = wrap.build_host(min_degree_bits=CFG["degree_bits"])
    return _CACHE["port"]


def jax_wrap():
    """The same wrap built and committed by the JAX package through its
    public recursion API, both circuits under its
    `standard_recursion_config()`, which the configuration states; the
    leaf's common data is that of the JAX dummy circuit, whose gates and
    selectors do not depend on its degree, at degree 14."""
    if "jax" not in _CACHE:
        from plonky2_tpu.plonk.circuit_builder import \
            CircuitBuilder as JBuilder
        from plonky2_tpu.plonk.config import CircuitConfig as JConfig
        from plonky2_tpu.recursion import targets as jtargets
        from plonky2_tpu.recursion.verifier import verify_proof_circuit

        inner = CFG["inner_config"]
        leaf_config = wrap_config = JConfig.standard_recursion_config()
        builder = JBuilder(leaf_config, seed=SEED)
        builder.register_public_inputs(
            builder.add_virtual_targets(inner["num_public_inputs"]))
        small = builder.build(min_degree_bits=6)
        common = dataclasses.replace(
            small.common, fri_params=leaf_config.fri_config.fri_params(
                inner["degree_bits"], inner["zero_knowledge"]))
        builder = JBuilder(wrap_config, seed=1234)
        pt = jtargets.add_virtual_proof_with_pis(builder, common)
        vt = jtargets.add_virtual_verifier_data(
            builder, wrap_config.fri_config.cap_height)
        verify_proof_circuit(builder, pt, vt, common)
        builder.register_public_inputs(pt.public_inputs)
        for digest in vt.constants_sigmas_cap:
            builder.register_public_inputs(digest)
        builder.register_public_inputs(vt.circuit_digest)
        _CACHE["jax"] = builder.build(min_degree_bits=CFG["degree_bits"])
    return _CACHE["jax"]


# -- (a) each gate type's constraints ---------------------------------------

@pytest.mark.parametrize("gate_id", CFG["gates"],
                         ids=lambda g: g.split(" ")[0].split("(")[0] + (
                             g.split("num_limbs: ")[1].split(" ")[0]
                             if "num_limbs" in g else ""))
def test_reference_gate_equals_the_port(gate_id):
    ours = ref_wrap.gate(gate_id, CFG)
    theirs = next(g for g in port_wrap().common.gates if g.id() == gate_id)
    assert (ours.degree, ours.num_constraints) == (theirs.degree(),
                                                   theirs.num_constraints())
    rnd = random.Random(gate_id)
    for _ in range(3):
        wires = [(rnd.randrange(P), rnd.randrange(P))
                 for _ in range(CFG["num_wires"])]
        consts = [(rnd.randrange(P), rnd.randrange(P))
                  for _ in range(CFG["num_constants"])]
        pi_hash = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(4)]
        got = ours.constraints(consts, wires, pi_hash)
        want = theirs.eval_unfiltered(EXT, consts, wires, pi_hash)
        assert got == [tuple(c) for c in want]


def test_reference_refuses_an_unknown_gate():
    with pytest.raises(ValueError):
        ref_wrap.gate("ExponentiationGate { num_power_bits: 66, "
                      "_phantom: PhantomData<plonky2_field::goldilocks_"
                      "field::GoldilocksField> }<D=2>", CFG)
    with pytest.raises(ValueError):
        ref_wrap.gate("ArithmeticGate { num_ops: 20 } ", CFG)


# -- (b) the pinned verifier key ---------------------------------------------

def test_pinned_key_is_the_jax_package_s_commitment():
    outer = jax_wrap()
    key = CFG["verifier_key"]
    assert [[int(x) for x in d]
            for d in outer.verifier_only.constants_sigmas_cap] == \
        key["constants_sigmas_cap"]
    assert [int(x) for x in outer.verifier_only.circuit_digest] == \
        key["circuit_digest"]
    circuit = ref_wrap.circuit(CFG)
    assert len(circuit.groups) == 3 and circuit.num_constants == 5
    assert [g.id for g in circuit.gates] == CFG["gates"]


def test_port_layout_equals_the_jax_package_s():
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.ops import ntt
    host, outer = port_wrap(), jax_wrap()
    common = host.common
    assert [g.id() for g in common.gates] == CFG["gates"] == \
        [g.id() for g in outer.common.gates]
    assert common.degree_bits == outer.common.degree_bits == \
        CFG["degree_bits"]
    assert len(host.public_inputs) == CFG["num_public_inputs"] == 72
    assert len(common.selectors_info.groups) == CFG["selector_groups"]
    assert len(host.generators) == 13022
    po = outer.prover_only
    nc = outer.common.num_constants
    assert nc == common.num_constants == 5
    np.testing.assert_array_equal(host.constants_sigmas[nc:], po.sigmas)
    coeffs = ntt.ifft(gl.from_u64(host.constants_sigmas[:nc], "cpu"))
    np.testing.assert_array_equal(
        gl.to_u64(coeffs),
        po.constants_sigmas_commitment.polynomials.to_u64()[:nc])


def test_configuration_copies_the_leaf_s_settings():
    """The wrap's and the leaf's settings are plonky2's
    standard_recursion_config(), and `inner_config` is the leaf's file."""
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    standard = CircuitConfig.standard_recursion_config()
    assert LEAF.circuit_config(CFG) == standard
    assert LEAF.circuit_config(CFG["inner_config"]) == standard
    leaf = load.data("configs", CFG["inner"])
    assert CFG["inner_config"] == {k: leaf[k] for k in CFG["inner_config"]}
    assert set(leaf) - set(CFG["inner_config"]) == {
        "name", "source", "describes", "guarantees", "reduced", "assumed"}


# -- (c) a small wrap through the reference's check --------------------------

def small():
    """(configuration, leaf System, the wrap's host circuit, golden data):
    the small wrap's configuration carries its own gates and key."""
    if "small" not in _CACHE:
        golden = json.load(open(SMALL_JSON))
        cfg = _apply(CFG, dict(SMALL, gates=golden["gates"],
                               selector_groups=golden["selector_groups"],
                               verifier_key=golden["verifier_key"]))
        leaf = LEAF.System(cfg["inner_config"], "cpu", SEED)
        builder, witness = wrap_circuit(leaf.data, register_inner=True,
                                        config=LEAF.circuit_config(cfg))
        host = builder.build_host(min_degree_bits=cfg["degree_bits"])
        _CACHE["small"] = cfg, leaf, host, witness, golden
    return _CACHE["small"]


def _calls(tamper=None):
    cfg, leaf, host, _, golden = small()
    proof = serialization.deserialize_proof_with_pis(
        open(SMALL_PROOF, "rb").read(), host.common)
    plain = WRAP.System.plain(proof)
    if tamper:
        tamper(plain)
    return cfg, [{"inputs": [golden["inputs"]], "proofs": [plain]}]


def test_small_wrap_passes_the_reference():
    cfg, calls = _calls()
    assert len(calls[0]["proofs"][0]["public_inputs"]) == 72
    numbers, reasons = ref_wrap.check(cfg, calls, [0], "cpu")
    assert numbers == {"wrong_inputs": (0, 0), "refused": (0, 0)}, reasons


def _flip_opening(plain):
    w = plain["openings"]["wires"]
    w[7] = ((w[7][0] + 1) % P, w[7][1])


def _change_input(plain):
    plain["public_inputs"][5] = (plain["public_inputs"][5] + 1) % P


@pytest.mark.parametrize("tamper,number", [(_flip_opening, "refused"),
                                           (_change_input, "wrong_inputs")],
                         ids=["opening", "public-input"])
def test_small_wrap_tampered_is_refused(tamper, number):
    cfg, calls = _calls(tamper)
    numbers, reasons = ref_wrap.check(cfg, calls, [0], "cpu")
    assert numbers["refused"] == (1, 0), reasons
    assert numbers[number][0] == 1


def test_small_wrap_key_is_the_port_s_layout():
    """The golden key's circuit is this layout: the program's commitment
    of it, when the golden files were made, gave the key, and the digest
    is the cap's."""
    cfg, _, host, _, golden = small()
    assert [g.id() for g in host.common.gates] == golden["gates"]
    assert host.common.degree_bits == cfg["degree_bits"]
    assert golden["layout_sha256"] == _sha256(host.constants_sigmas)
    ref_wrap.circuit(cfg)           # the digest is the cap's, or it raises


def _sha256(values: np.ndarray) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(
        values, dtype=np.uint64).tobytes()).hexdigest()


# -- (d) the fixpoint's spans and counters -----------------------------------

def test_fixpoint_spans_and_counters():
    """The wrap's fixpoint as a prove runs it, inside `run generators` of
    an enabled tree: both spans once, inside it, and the counters."""
    cfg, leaf, host, witness, _ = small()
    inner = serialization.deserialize_proof_with_pis(
        open(SMALL_INNER, "rb").read(), leaf.data.common)
    tree = TimingTree(enabled=True)
    with tree.scope("run generators"):
        generate_partial_witness(witness(inner), host, host.common)
    parents = {s.id: s.label for s in tree.spans}
    inside = [s.label for s in tree.spans if s.parent is not None
              and parents[s.parent] == "run generators"]
    assert inside == ["generator index", "generator passes"]
    assert tree.counts["generator_runs"] >= len(host.generators)
    assert 1 <= tree.counts["generator_passes"] <= \
        tree.counts["generator_runs"]
    assert tree.span_counts["run generators"] == {
        "generator_runs": tree.counts["generator_runs"],
        "generator_tape_runs": tree.counts["generator_tape_runs"],
        "generator_passes": tree.counts["generator_passes"],
        "generator_replays": tree.counts["generator_replays"]}
    off = TimingTree(enabled=False)
    with off.scope("run generators"):
        generate_partial_witness(witness(inner), host, host.common)
    assert off.counts == {} and off.spans == []


def test_fixpoint_counts_are_pinned():
    """The small wrap's fixpoint, recording, runs its generators as often,
    in as many passes, as the worklist did when it kept its own list of the
    newly set representatives (pinned); replaying, once each in one pass;
    its wire matrix carries every set representative once."""
    cfg, leaf, host, witness, _ = small()
    inner = serialization.deserialize_proof_with_pis(
        open(SMALL_INNER, "rb").read(), leaf.data.common)
    host._witness_plan = None           # the circuit's next proof records
    for runs, passes, replays in ((12983, 293, 0), (6890, 1, 1)):
        tree = TimingTree(enabled=True)
        with tree.scope("run generators"):
            full = generate_partial_witness(witness(inner), host,
                                            host.common)
        with tree.scope("wire matrix"):
            wire_matrix([full])
        assert tree.counts["generator_runs"] == runs
        assert tree.counts["generator_passes"] == passes
        assert tree.counts["generator_replays"] == replays
        set_count = sum(v is not None for v in full.as_list())
        assert tree.counts["wire_values"] == len(full.set_reps) == set_count
        assert set_count == 35778
    assert len(host.generators) == 6890


def make_golden() -> None:
    """Prove the small wrap once through the configuration's own System on
    the CPU and write the golden files."""
    from benchmark.reference import plain_torch
    cfg = _apply(CFG, SMALL)
    system = WRAP.System(cfg, "cpu", SEED)
    rng = np.random.default_rng(SEED)
    inputs = WRAP.draw(rng, cfg)
    prepared = system.prepare([inputs])
    inner = system.leaf.data.prove(prepared[0])
    wrap = system.data.prove(system.witness(inner))
    system.data.verify(wrap)
    common = system.data.common
    builder, _ = wrap_circuit(system.leaf.data, register_inner=True,
                              config=LEAF.circuit_config(cfg))
    host = builder.build_host(min_degree_bits=cfg["degree_bits"])
    cap = [[int(x) for x in d]
           for d in system.data.verifier_only.constants_sigmas_cap]
    assert cap == [list(d) for d in plain_torch.commitment_cap(
        host.constants_sigmas, cfg["fri"]["rate_bits"],
        cfg["fri"]["cap_height"], "cpu")]
    golden = {
        "inputs": [int(x) for x in inputs],
        "gates": [g.id() for g in common.gates],
        "selector_groups": len(common.selectors_info.groups),
        "verifier_key": {
            "constants_sigmas_cap": cap,
            "circuit_digest": [int(x) for x in
                               system.data.verifier_only.circuit_digest]},
        "layout_sha256": _sha256(host.constants_sigmas),
    }
    with open(SMALL_JSON, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    with open(SMALL_PROOF, "wb") as f:
        f.write(serialization.serialize_proof_with_pis(wrap, common))
    with open(SMALL_INNER, "wb") as f:
        f.write(serialization.serialize_proof_with_pis(
            inner, system.leaf.data.common))


if __name__ == "__main__":
    sys.modules["jax"] = None
    sys.modules["plonky2_tpu"] = None
    torch.set_num_threads(2)
    make_golden()
