"""The reference on its own (Poseidon's known answers, its plain PyTorch
arithmetic), against the program where they must agree (the layout, the
commitment, the Poseidon gate's constraints), and on small CPU proofs of
both configurations: accepted as made, refused when tampered."""

import copy
import random

import numpy as np
import pytest
import torch

from benchmark import load
from benchmark.reference import fri, plain_torch
from benchmark.reference.common import REFUSALS
from benchmark.reference import poseidon as ps
from benchmark.reference import recursion_leaf_d14 as leaf
from benchmark.reference import starky_fib_r20 as fib
from benchmark.reference.field import P, e_mul, e_pow

# plonky2 hash/poseidon_goldilocks.rs test vectors, width 12
KATS = [
    ([0] * 12,
     [0x3c18a9786cb0b359, 0xc4055e3364a246c3, 0x7953db0ab48808f4,
      0xc71603f33a1144ca, 0xd7709673896996dc, 0x46a84e87642f44ed,
      0xd032648251ee0b3c, 0x1c687363b207df62, 0xdf8565563e8045fe,
      0x40f5b37ff4254dae, 0xd070f637b431067c, 0x1792b1c4342109d7]),
    (list(range(12)),
     [0xd64e1e3efc5b8e9e, 0x53666633020aaa47, 0xd40285597c6a8825,
      0x613a4f81e81231d2, 0x414754bfebd051f0, 0xcb1f8980294a023f,
      0x6eb2a9e4d54a9d0f, 0x1902bc3af467e056, 0xf045d5eafdc6021f,
      0xe4150f77caaa3be5, 0xc9bfd01d39b50cce, 0x5c0a27fcb0e1459b]),
    ([P - 1] * 12,
     [0xbe0085cfc57a8357, 0xd95af71847d05c09, 0xcf55a13d33c1c953,
      0x95803a74f4530e82, 0xfcd99eb30a135df1, 0xe095905e913a3029,
      0xde0392461b42919b, 0x7d3260e24e81d031, 0x10d3d0465d9deaa0,
      0xa87571083dfc2a47, 0xe18263681e9958f8, 0xe28e96f1ae5e60d3]),
    ([0x8ccbbbea4fe5d2b7, 0xc2af59ee9ec49970, 0x90f7e1a9e658446a,
      0xdcc0630a3ab8b1b8, 0x7ff8256bca20588c, 0x5d99a7ca0c44ecfb,
      0x48452b17a70fbee3, 0xeb09d654690b6c88, 0x4a55d3a39c676a88,
      0xc0407a38d2285139, 0xa234bac9356386d1, 0xe1633f2bad98a52f],
     [0xa89280105650c4ec, 0xab542d53860d12ed, 0x5704148e9ccab94f,
      0xd3a826d4b62da9f5, 0x8a7a6ca87892574f, 0xc7017e1cad1a674e,
      0x1f06668922318e34, 0xa3b203bc8102676f, 0xfcc781b0ce382bf2,
      0x934c69ff3ed14ba5, 0x504688a5996e8f13, 0x401f3f2ed524a2ba]),
]
LEAF_DEGREE = 6      # one FRI fold at rate 2^-3
FIB_DEGREE = 8       # one FRI fold at rate 1/2


@pytest.mark.parametrize("inputs,outputs", KATS)
def test_poseidon_known_answers(inputs, outputs):
    assert ps.permute(inputs) == outputs
    lanes = plain_torch.from_u64(np.asarray(inputs, dtype=np.uint64)
                                 .reshape(12, 1), "cpu")
    got = plain_torch.permute_lanes(lanes, plain_torch._tables("cpu"))
    assert [int(v) for v in plain_torch.to_u64(got)[:, 0]] == outputs


def test_plain_torch_field_against_python_ints():
    rng = np.random.default_rng(7)
    a = rng.integers(0, P, 4096, dtype=np.uint64)
    b = rng.integers(0, P, 4096, dtype=np.uint64)
    a[:4], b[:4] = [0, 1, P - 1, P - 2], [P - 1, P - 1, P - 1, 1 << 63]
    ta, tb = plain_torch.from_u64(a, "cpu"), plain_torch.from_u64(b, "cpu")
    for op, f in ((plain_torch.add, lambda x, y: (x + y) % P),
                  (plain_torch.sub, lambda x, y: (x - y) % P),
                  (plain_torch.mul, lambda x, y: x * y % P)):
        got = plain_torch.to_u64(op(ta, tb))
        assert [int(v) for v in got] == [f(int(x), int(y))
                                         for x, y in zip(a, b)]


def test_coset_lde_against_direct_evaluation():
    from benchmark.reference.field import GENERATOR, root_of_unity
    rng = np.random.default_rng(8)
    values = rng.integers(0, P, (3, 8), dtype=np.uint64)
    lde = plain_torch.to_u64(plain_torch.coset_lde(
        plain_torch.from_u64(values, "cpu"), 2))
    w8, w32 = root_of_unity(3), root_of_unity(5)
    inv8 = pow(8, P - 2, P)
    for row in range(3):
        coeffs = [sum(int(values[row, j]) * pow(w8, -i * j % 8, P)
                      for j in range(8)) * inv8 % P for i in range(8)]
        for i in range(32):
            x = GENERATOR * pow(w32, i, P) % P
            assert int(lde[row, i]) == sum(c * pow(x, k, P)
                                           for k, c in enumerate(coeffs)) % P


def test_poseidon_gate_constraints_against_the_program():
    """The textbook schedule here and the program's fast partial rounds
    are one polynomial map: equal at random extension points."""
    from plonky2_tpu_torch.gates.gate import EXT
    from plonky2_tpu_torch.gates.poseidon_gate import PoseidonGate
    rnd = random.Random(9)
    for _ in range(3):
        wires = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(135)]
        ours = leaf.poseidon_constraints([], wires, [])
        theirs = PoseidonGate().eval_unfiltered(EXT, [], wires, [])
        assert ours == [tuple(c) for c in theirs]


def test_fibonacci_public_inputs_and_traces():
    cfg = dict(load.data("configs", "starky_fib_r20"), degree_bits=6)
    system = load.module("configs", "starky_fib_r20").System(cfg, "cpu", 1)
    for x0, x1 in [(0, 1), (P - 1, 5), (123456789123, P - 7)]:
        trace, pis = system.prepare([(x0, x1)])[0]
        a, b = x0, x1
        for i in range(64):
            assert (int(trace[0, i]), int(trace[1, i])) == (a, b)
            a, b = b, (a + b) % P
        assert pis == fib.public_inputs(cfg, x0, x1) == [x0, x1,
                                                         int(trace[1, -1])]


def _leaf_cfg():
    return dict(load.data("configs", "recursion_leaf_d14"),
                degree_bits=LEAF_DEGREE)


def test_leaf_layout_and_key_equal_the_programs():
    cfg = _leaf_cfg()
    driver = load.module("configs", "recursion_leaf_d14")
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    builder = CircuitBuilder(driver.circuit_config(cfg), seed=3)
    builder.register_public_inputs(builder.add_virtual_targets(4))
    host = builder.build_host(min_degree_bits=LEAF_DEGREE)
    gates, groups, values = leaf.layout(cfg)
    assert [g.id for g in gates] == [g.id() for g in host.common.gates]
    assert groups == host.common.selectors_info.groups
    assert np.array_equal(values, host.constants_sigmas)
    system = driver.System(cfg, "cpu", 3)
    ours = leaf.circuit(cfg, "cpu")
    theirs = system.data.verifier_only
    assert ours.cap == [tuple(int(x) for x in d)
                        for d in theirs.constants_sigmas_cap]
    assert ours.digest == tuple(int(x) for x in theirs.circuit_digest)


@pytest.fixture(scope="module")
def leaf_proof():
    from plonky2_tpu_torch.utils.timing import TimingTree
    torch.set_num_threads(2)
    cfg = _leaf_cfg()
    driver = load.module("configs", "recursion_leaf_d14")
    system = driver.System(cfg, "cpu", 4)
    pis = [5, P - 1, 0, 2 ** 40]
    proof = system.prove(system.prepare([pis]), TimingTree(enabled=False))
    return cfg, leaf.circuit(cfg, "cpu"), driver.System.plain(proof[0]), pis


@pytest.fixture(scope="module")
def fib_proof():
    from plonky2_tpu_torch.utils.timing import TimingTree
    torch.set_num_threads(2)
    cfg = dict(load.data("configs", "starky_fib_r20"),
               degree_bits=FIB_DEGREE)
    driver = load.module("configs", "starky_fib_r20")
    system = driver.System(cfg, "cpu", 4)
    x = (3, P - 11)
    proof = system.prove(system.prepare([x]), TimingTree(enabled=False))
    return cfg, driver.System.plain(proof[0]), fib.public_inputs(cfg, *x)


def _bump_ext(v):
    return ((v[0] + 1) % P, v[1])


def _bump_digest(d):
    return ((d[0] + 1) % P,) + tuple(d[1:])


# (name, change made to a plain proof in place)
TAMPER = [
    ("wire opening", lambda p: p["openings"]["wires"].__setitem__(
        0, _bump_ext(p["openings"]["wires"][0]))),
    ("quotient opening", lambda p: p["openings"]["quotient_polys"]
     .__setitem__(1, _bump_ext(p["openings"]["quotient_polys"][1]))),
    ("first cap", lambda p: p["caps"][0].__setitem__(
        3, _bump_digest(p["caps"][0][3]))),
    ("last cap", lambda p: p["caps"][-1].__setitem__(
        0, _bump_digest(p["caps"][-1][0]))),
    ("proof of work", lambda p: p["fri"].__setitem__(
        "pow_witness", p["fri"]["pow_witness"] + 1)),
    ("final polynomial", lambda p: p["fri"]["final_poly"].__setitem__(
        0, _bump_ext(p["fri"]["final_poly"][0]))),
    ("leaf value", lambda p: p["fri"]["queries"][5]["initial"][-1][0]
     .__setitem__(0, (p["fri"]["queries"][5]["initial"][-1][0][0] + 1)
                  % P)),
    ("path digest", lambda p: p["fri"]["queries"][2]["initial"][0][1]
     .__setitem__(1, _bump_digest(
         p["fri"]["queries"][2]["initial"][0][1][1]))),
    ("fold value", lambda p: p["fri"]["queries"][7]["steps"][0][0]
     .__setitem__(3, _bump_ext(p["fri"]["queries"][7]["steps"][0][0][3]))),
    ("a query dropped", lambda p: p["fri"]["queries"].pop()),
    ("public input", lambda p: p["public_inputs"].__setitem__(
        0, (p["public_inputs"][0] + 1) % P)),
]


def test_leaf_proof_accepted(leaf_proof):
    cfg, circuit, proof, pis = leaf_proof
    leaf.verify(circuit, proof, pis)


@pytest.mark.parametrize("name,change", TAMPER, ids=[t[0] for t in TAMPER])
def test_leaf_proof_tampered_refused(leaf_proof, name, change):
    cfg, circuit, proof, pis = leaf_proof
    bad = copy.deepcopy(proof)
    change(bad)
    with pytest.raises(REFUSALS):
        leaf.verify(circuit, bad, pis)


def test_leaf_proof_of_another_statement_refused(leaf_proof):
    cfg, circuit, proof, pis = leaf_proof
    with pytest.raises(fri.Refused):
        leaf.verify(circuit, proof, [pis[0] + 1] + pis[1:])


def test_leaf_proof_under_fewer_pow_bits_refused(leaf_proof):
    """The control's check: a verifier held to 20 bits refuses a proof made
    for 16 (its response has 20 leading zero bits by chance only)."""
    cfg, circuit, proof, pis = leaf_proof
    strict = copy.deepcopy(circuit)
    strict.cfg = dict(cfg, fri=dict(cfg["fri"], proof_of_work_bits=30))
    with pytest.raises(fri.Refused, match="proof of work"):
        leaf.verify(strict, proof, pis)


def test_fib_proof_accepted(fib_proof):
    cfg, proof, pis = fib_proof
    fib.verify(cfg, proof, pis)


@pytest.mark.parametrize("name,change", [t for t in TAMPER
                                         if t[0] != "wire opening"]
                         + [("trace opening", lambda p: p["openings"][
                             "next_values"].__setitem__(1, _bump_ext(
                                 p["openings"]["next_values"][1])))],
                         ids=[t[0] for t in TAMPER if t[0] != "wire opening"]
                         + ["trace opening"])
def test_fib_proof_tampered_refused(fib_proof, name, change):
    cfg, proof, pis = fib_proof
    bad = copy.deepcopy(proof)
    change(bad)
    with pytest.raises(REFUSALS):
        fib.verify(cfg, bad, pis)


def test_fib_proof_of_another_table_refused(fib_proof):
    cfg, proof, pis = fib_proof
    with pytest.raises(fri.Refused):
        fib.verify(cfg, proof, pis[:2] + [(pis[2] + 1) % P])


def test_extension_arithmetic():
    a = (3, 5)
    assert e_pow(a, P * P - 1) == (1, 0)
    assert e_mul(a, (1, 0)) == a
