"""The witness tape (plonky2_tpu_torch/iop/tape.py, csrc/witness_tape.c):
each lowered generator kind's op against its Python `run_once`, at the
gate parameters `standard_recursion_config()` gives the wrap, on random
canonical values and on edge values (0, 1, p - 1, p - 2^32), every index of
RandomAccess and both swap bits of the Poseidon gate; an op's own checks and
a conflicting write; and the fixpoint's fallbacks: a tape op that is not
ready makes the proof run the worklist, a conflicting write and a
RandomAccess index out of range raise under the tape as in Python, and
wire matrices of tape replays equal the dense walk of their values.
Tolerance: exact.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from plonky2_tpu_torch import host  # noqa: E402
from plonky2_tpu_torch.gates import basic_gates as bg  # noqa: E402
from plonky2_tpu_torch.gates import extension_gates as eg  # noqa: E402
from plonky2_tpu_torch.gates import misc_gates as mg  # noqa: E402
from plonky2_tpu_torch.gates import poseidon_gate as pg  # noqa: E402
from plonky2_tpu_torch.iop import tape  # noqa: E402
from plonky2_tpu_torch.iop.generator import (  # noqa: E402
    SimpleGenerator, generate_partial_witness,
)
from plonky2_tpu_torch.iop.target import wire  # noqa: E402
from plonky2_tpu_torch.iop.witness import (  # noqa: E402
    PartialWitness, PartitionWitness, wire_matrix,
)
from plonky2_tpu_torch.plonk.circuit_builder import \
    CircuitBuilder  # noqa: E402
from plonky2_tpu_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu_torch.utils.timing import TimingTree  # noqa: E402

P = (1 << 64) - (1 << 32) + 1
NUM_WIRES = 135
CONFIG = CircuitConfig.standard_recursion_config()
GATES = {
    "poseidon": pg.PoseidonGate(),
    "arithmetic": bg.ArithmeticGate.from_config(CONFIG),
    "arithmetic_extension": eg.ArithmeticExtensionGate.from_config(CONFIG),
    "mul_extension": eg.MulExtensionGate.from_config(CONFIG),
    "reducing": eg.ReducingGate(43),
    "reducing_extension": eg.ReducingExtensionGate(32),
    "random_access": mg.RandomAccessGate.from_config(CONFIG, 4),
}
EDGES = (0, 1, P - 1, P - (1 << 32))
VALUES = ["random", *EDGES]


@pytest.fixture(scope="module")
def lib():
    lib = host.load()
    if lib is None:
        pytest.fail("the host C library does not build here")
    return lib


def _value(rng, values):
    return int(rng.integers(0, P, dtype=np.uint64)) if values == "random" \
        else values


def _witness():
    return PartitionWitness(np.arange(NUM_WIRES, dtype=np.int64),
                            NUM_WIRES, 1)


def _run_both(lib, gen, deps: dict):
    """Run `gen` in Python and as a tape op, each on a witness holding
    `deps` (wire -> value); -> the two witnesses."""
    py, tp = _witness(), _witness()
    for w in (py, tp):
        for c, v in deps.items():
            w.set(wire(0, c), v)
    out = []
    gen.run_once(py, out)
    for t, v in out:
        py.set(t, v)
    op = tape.encode(gen.tape_op(), tp.rep_index, tuple(t for t, _ in out))
    assert op is not None
    done, status = tape.Tape(op, [None], NUM_WIRES).run(lib, tp)
    assert (done, status) == (1, tape.OK)
    return py, tp


def _assert_same(got, want) -> None:
    np.testing.assert_array_equal(got.set_reps, want.set_reps)
    assert got.as_list() == want.as_list()


def _deps(name, gen, rng, values) -> dict:
    deps = {t[2]: _value(rng, values) for t in gen.dependencies()}
    if name == "poseidon":
        deps[pg.PoseidonGate.WIRE_SWAP] = int(rng.integers(0, 2))
    return deps


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("name", [n for n in GATES if n != "random_access"])
def test_op_equals_run_once(lib, name, values):
    """Every generator of the gate's row, its dependencies and constants
    random or all one edge value: the tape writes what `run_once` writes,
    in its order."""
    g = GATES[name]
    rng = np.random.default_rng([list(GATES).index(name),
                                 VALUES.index(values)])
    consts = [_value(rng, values) for _ in range(g.num_constants())]
    for gen in g.generators(0, consts):
        py, tp = _run_both(lib, gen, _deps(name, gen, rng, values))
        _assert_same(tp, py)
        assert len(py.set_reps) > len(gen.dependencies())


@pytest.mark.parametrize("swap", [0, 1])
@pytest.mark.parametrize("values", VALUES)
def test_poseidon_op_both_swap_bits(lib, values, swap):
    gen = GATES["poseidon"].generators(0, [])[0]
    rng = np.random.default_rng([swap, VALUES.index(values)])
    deps = _deps("poseidon", gen, rng, values)
    deps[pg.PoseidonGate.WIRE_SWAP] = swap
    py, tp = _run_both(lib, gen, deps)
    _assert_same(tp, py)
    # all 135 columns of the row are set: 13 inputs and 122 outputs
    assert tp.flags.sum() == NUM_WIRES


@pytest.mark.parametrize("values", VALUES)
def test_random_access_op_every_index(lib, values):
    g = GATES["random_access"]
    rng = np.random.default_rng([7, VALUES.index(values)])
    for gen in g.generators(0, [0] * g.num_constants()):
        for idx in range(g.vec_size()):
            deps = _deps("random_access", gen, rng, values)
            deps[g.wire_access_index(gen.copy)] = idx
            py, tp = _run_both(lib, gen, deps)
            _assert_same(tp, py)


def _refused(lib, gen, deps: dict):
    """-> the tape's (done, status) of `gen` on `deps`, and the witness."""
    w = _witness()
    for c, v in deps.items():
        w.set(wire(0, c), v)
    op = tape.encode(gen.tape_op(), w.rep_index, tuple(gen.tape_op()[3]))
    return tape.Tape(op, [None], NUM_WIRES).run(lib, w), w


def test_ops_refuse_what_their_generators_refuse(lib):
    """A RandomAccess index of the vector's size or more, and a Poseidon
    swap wire other than 0 or 1: the op writes nothing, and `run_once`
    raises."""
    g = GATES["random_access"]
    gen = g.generators(0, [0] * g.num_constants())[0]
    rng = np.random.default_rng(3)
    for idx in (g.vec_size(), P - 1):
        deps = _deps("random_access", gen, rng, "random")
        deps[g.wire_access_index(0)] = idx
        (done, status), w = _refused(lib, gen, deps)
        assert (done, status) == (0, tape.REFUSED)
        assert len(w.set_reps) == len(deps)
        with pytest.raises(AssertionError, match="Access index"):
            gen.run_once(w, [])
    gen = GATES["poseidon"].generators(0, [])[0]
    deps = _deps("poseidon", gen, rng, "random")
    deps[pg.PoseidonGate.WIRE_SWAP] = 2
    (done, status), w = _refused(lib, gen, deps)
    assert (done, status) == (0, tape.REFUSED)
    with pytest.raises(AssertionError):
        gen.run_once(w, [])


def test_a_conflicting_write_stops_the_tape(lib):
    """An output set to another value: the op stops there, with the writes
    before it made, and the ops after it not run."""
    gen = GATES["reducing"].generators(0, [])[0]
    rng = np.random.default_rng(4)
    deps = _deps("reducing", gen, rng, "random")
    py, _ = _run_both(lib, gen, deps)
    outs = gen.tape_op()[3]
    w = _witness()
    for c, v in deps.items():
        w.set(wire(0, c), v)
    w.set(outs[5], py.get(outs[5]) + 1)
    op = tape.encode(gen.tape_op(), w.rep_index, tuple(outs))
    done, status = tape.Tape(op + op, [None, None], NUM_WIRES).run(lib, w)
    assert (done, status) == (0, tape.CONFLICT)
    assert [w.try_get(t) for t in outs[:5]] == [py.get(t) for t in outs[:5]]
    assert w.try_get(outs[6]) is None
    assert len(w.set_reps) == len(deps) + 1 + 5


def test_a_tape_op_waits_for_its_dependencies(lib):
    gen = GATES["arithmetic"].generators(0, [3, 4])[0]
    w = _witness()
    w.set(gen.dependencies()[0], 5)
    op = tape.encode(gen.tape_op(), w.rep_index, tuple(gen.tape_op()[3]))
    assert tape.Tape(op, [None], NUM_WIRES).run(lib, w) == (0, tape.NOT_READY)
    assert len(w.set_reps) == 1


def test_a_tape_refuses_a_store_of_another_size(lib):
    gen = GATES["arithmetic"].generators(0, [3, 4])[0]
    w = _witness()
    op = tape.encode(gen.tape_op(), w.rep_index, tuple(gen.tape_op()[3]))
    with pytest.raises(ValueError, match="store of 136"):
        tape.Tape(op, [None], NUM_WIRES + 1).run(lib, w)
    assert len(w.set_reps) == 0


def test_encode_keeps_what_does_not_lower_in_python():
    """Other targets than recorded, or more outputs than an op holds."""
    gen = GATES["arithmetic"].generators(0, [3, 4])[0]
    rep = _witness().rep_index
    assert tape.encode(gen.tape_op(), rep, (wire(0, 1),)) is None
    big = (tape.ARITHMETIC, [wire(0, 0)] * (tape.MAX_DEPS_OR_OUTS + 1),
           (3, 4), [wire(0, 3)])
    assert tape.encode(big, rep, (wire(0, 3),)) is None


# -- the fixpoint -------------------------------------------------------------

def _fixpoint(pw, host_data):
    tree = TimingTree(enabled=True)
    with tree.scope("run generators"):
        witness = generate_partial_witness(pw, host_data, host_data.common)
    return witness, tree.counts


def _pw(pairs) -> PartialWitness:
    pw = PartialWitness()
    pw.set_targets(pairs)
    return pw


class _Square(SimpleGenerator):
    """Writes x^2 to `out`: a step the tape does not lower."""

    def __init__(self, x, out):
        self.x, self.out = x, out

    def dependencies(self):
        return [self.x]

    def run_once(self, witness, out):
        out.append((self.out, witness.get(self.x) ** 2))


def _chain():
    """y = x^2 in Python, then z = y * y + x on the tape."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=7)
    x, y = builder.add_virtual_target(), builder.add_virtual_target()
    builder.add_simple_generator(_Square(x, y))
    z = builder.mul_add(y, y, x)
    builder.register_public_input(z)
    return builder.build_host(), x, z


def test_a_tape_op_not_ready_falls_back_to_the_worklist():
    """A plan whose tape runs ahead of the Python step that sets its
    dependency: the op is not ready, the proof runs the worklist from a
    fresh witness and records a plan that holds."""
    host_data, x, z = _chain()
    want, _ = _fixpoint(_pw([(x, 3)]), host_data)
    plan = host_data._witness_plan
    segments = plan.segments
    py = next(i for i, s in enumerate(segments)
              if not isinstance(s, tape.Tape)
              and isinstance(s[0].__self__, _Square))
    ahead = next(i for i, s in enumerate(segments)
                 if isinstance(s, tape.Tape) and i > py)
    segments.insert(py, segments.pop(ahead))
    got, counts = _fixpoint(_pw([(x, 3)]), host_data)
    assert counts["generator_replays"] == 0
    assert counts["generator_passes"] >= 2
    assert got.get(z) == 84 == want.get(z)
    np.testing.assert_array_equal(got.set_reps, want.set_reps)
    assert host_data._witness_plan is not plan
    _, counts = _fixpoint(_pw([(x, 3)]), host_data)
    assert counts["generator_replays"] == 1
    assert counts["generator_tape_runs"] >= 1


@pytest.mark.parametrize("replay", ["tape", "python"])
def test_conflicting_tape_writes_raise(replay, monkeypatch):
    """Two arithmetic ops write a * b and a + b into one partition: they
    agree at a = b = 2, so the plan records; at a = b = 3 the replay
    raises as the worklist does, on the tape or in Python."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=7)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    builder.connect(builder.mul(a, b), builder.add(a, b))
    host_data = builder.build_host()
    _fixpoint(_pw([(a, 2), (b, 2)]), host_data)
    _, counts = _fixpoint(_pw([(a, 2), (b, 2)]), host_data)
    assert counts["generator_replays"] == 1
    assert counts["generator_tape_runs"] >= 2
    if replay == "python":
        monkeypatch.setattr(host, "load", lambda: None)
    with pytest.raises(AssertionError, match="set twice with different"):
        _fixpoint(_pw([(a, 3), (b, 3)]), host_data)


@pytest.mark.parametrize("replay", ["tape", "python"])
def test_random_access_out_of_range_raises(replay, monkeypatch):
    """An index of the list's length, recorded at a valid index: the
    replay raises the generator's own assertion, on the tape or in
    Python."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=7)
    idx = builder.add_virtual_target()
    items = [builder.add_virtual_target() for _ in range(16)]
    builder.register_public_input(builder.random_access(idx, items))
    host_data = builder.build_host()
    pairs = [(t, 100 + i) for i, t in enumerate(items)]
    _fixpoint(_pw([(idx, 5)] + pairs), host_data)
    got, counts = _fixpoint(_pw([(idx, 9)] + pairs), host_data)
    assert counts["generator_replays"] == 1
    assert counts["generator_tape_runs"] >= 1
    if replay == "python":
        monkeypatch.setattr(host, "load", lambda: None)
    with pytest.raises(AssertionError, match="Access index 16"):
        _fixpoint(_pw([(idx, 16)] + pairs), host_data)


def _fib_host():
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(20):
        prev, cur = cur, builder.mul_add(prev, cur, prev)
    builder.register_public_input(cur)
    return builder.build_host(), a, b


@pytest.mark.parametrize("B", [1, 4])
def test_wire_matrix_of_tape_replays(B):
    """B fixpoints of one circuit, all but a recording's replayed on the
    tape: their wire matrix is the dense walk of each one's values."""
    host_data, a, b = _fib_host()
    witnesses = []
    for x in range(B + 1):
        w, counts = _fixpoint(_pw([(a, x), (b, 2 * x + 1)]), host_data)
        witnesses.append(w)
    assert counts["generator_tape_runs"] >= 20
    witnesses = witnesses[1:] if B > 1 else witnesses[-1:]
    n, nw = host_data.common.degree, host_data.common.config.num_wires
    want = []
    for w in witnesses:
        values = w.as_list()
        flat = np.asarray([values[r] or 0 for r in w.rep_list[:n * nw]],
                          dtype=np.uint64)
        want.append(flat.reshape(n, nw).T)
    np.testing.assert_array_equal(wire_matrix(witnesses),
                                  np.stack(want, axis=1))
