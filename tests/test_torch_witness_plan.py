"""The witness fixpoint's recorded plan (iop/generator.py): a circuit's first
proof runs the worklist and records the order in which its generators
completed and the representatives each wrote; later proofs whose inputs set
the same representatives replay it, each generator once.

- A replay equals the worklist bit for bit (values and `set_reps` order)
  under the same inputs and random stream, on the small wrap
  (tests/golden/wrap_small*), the cyclic hash chain's base and step (the
  plan recorded on the other condition) and the gadget circuits of
  tests/test_torch_gadgets.py, both where the lowered steps run on the
  witness tape (iop/tape.py) and where every step runs in Python (no host
  C library); and a fib proof made from a replay equals the one made from
  the worklist, byte for byte.
- Inputs that set other targets record a new plan.
- A partition set twice with different values raises under replay.
- A generator that writes other targets than recorded, or writes more, or
  is not ready where recorded, makes the proof fall back to the worklist.
- The counters of a recording and of a replay.

Everything runs at the host level (`build_host()`), but the fib proof,
which is small enough to prove on the CPU. Tolerance: exact.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import gadget_circuits  # noqa: E402
import service_circuits  # noqa: E402
from plonky2_tpu_torch import host as host_lib  # noqa: E402
from plonky2_tpu_torch.iop import tape  # noqa: E402
from plonky2_tpu_torch.iop.generator import (  # noqa: E402
    RandomValueGenerator, SimpleGenerator, generate_partial_witness,
)
from plonky2_tpu_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_tpu_torch.plonk.circuit_builder import \
    CircuitBuilder  # noqa: E402
from plonky2_tpu_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_tpu_torch.recursion import cyclic  # noqa: E402
from plonky2_tpu_torch.utils import serialization  # noqa: E402
from plonky2_tpu_torch.utils.timing import TimingTree  # noqa: E402

PKG = "plonky2_tpu_torch"


# -- helpers ------------------------------------------------------------------

def _forget(prover_data) -> None:
    """Drop the circuit's plan, so that its next proof records."""
    prover_data._witness_plan = None


def _streams(prover_data) -> list:
    """The random streams of the circuit's RandomValueGenerators."""
    return list({id(g.rng): g.rng for g in prover_data.generators
                 if isinstance(g, RandomValueGenerator)}.values())


def _rewinder(prover_data):
    """A function that puts the circuit's random streams back where they
    are now."""
    streams = _streams(prover_data)
    states = [s.bit_generator.state for s in streams]

    def rewind():
        for s, state in zip(streams, states):
            s.bit_generator.state = state
    return rewind


def _fixpoint(pw, host):
    """-> (witness, counters) of one fixpoint under an enabled tree."""
    tree = TimingTree(enabled=True)
    with tree.scope("run generators"):
        witness = generate_partial_witness(pw, host, host.common)
    return witness, tree.counts


def _pw(pairs) -> PartialWitness:
    pw = PartialWitness()
    pw.set_targets(pairs)
    return pw


def _assert_same(got, want) -> None:
    np.testing.assert_array_equal(got.set_reps, want.set_reps)
    assert got.as_list() == want.as_list()


def _tape_steps(prover_data) -> int:
    """The steps of the circuit's plan that its tapes run."""
    return sum(len(s.steps) for s in prover_data._witness_plan.segments
               if isinstance(s, tape.Tape))


@pytest.fixture(params=["tape", "python"])
def replay(request, monkeypatch):
    """Where the replay runs its lowered steps: on the witness tape, or, with
    no host C library, in Python."""
    if request.param == "python":
        monkeypatch.setattr(host_lib, "load", lambda: None)
    elif host_lib.load() is None:
        pytest.fail("the host C library does not build here")
    return request.param


# -- the circuits -------------------------------------------------------------

def _wrap_small():
    import test_bench_wrap_reference as wrap
    _, leaf, host, witness, _ = wrap.small()
    inner = serialization.deserialize_proof_with_pis(
        open(wrap.SMALL_INNER, "rb").read(), leaf.data.common)
    return host, lambda: witness(inner), None


def _cyclic(cond):
    """The hash chain of tests/test_torch_cyclic.py: the plan is recorded at
    the other condition, then `cond`'s proof replays it."""
    import test_torch_cyclic as chain
    goal = cyclic.common_data_for_recursion(chain._reduced_config(),
                                            chain.GOAL_DEGREE_BITS)
    host, inputs = chain.port_chain(goal)
    pairs = inputs(cond)
    other = inputs(1 - cond)
    return host, lambda: _pw(pairs), lambda: _pw(other)


def _gadget(name):
    builder, pw = getattr(gadget_circuits, name)(PKG)[:2]
    return builder.build_host(), lambda: pw, None


CASES = {
    "wrap_small": _wrap_small,
    "cyclic_base": lambda: _cyclic(0),
    "cyclic_step": lambda: _cyclic(1),
    "schnorr": lambda: _gadget("schnorr"),
    "secp256k1_curve": lambda: _gadget("secp256k1_curve"),
    "two_luts": lambda: _gadget("two_luts"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replay_equals_the_worklist(case, replay):
    """The worklist's witness (a recording), then the replay's from the
    same random stream: equal values, set in the same order; the tape runs
    the plan's lowered steps, or none with no host C library."""
    host, inputs, other = CASES[case]()
    _forget(host)       # the circuit may be another case's, with its plan
    rewind = _rewinder(host)
    want, counts = _fixpoint(inputs(), host)
    assert counts["generator_replays"] == 0
    if other is not None:       # the plan of the other condition
        _forget(host)
        _, counts = _fixpoint(other(), host)
        assert counts["generator_replays"] == 0
    rewind()
    got, counts = _fixpoint(inputs(), host)
    lowered = _tape_steps(host)
    assert counts == {"generator_runs": len(host.generators),
                      "generator_tape_runs":
                          lowered if replay == "tape" else 0,
                      "generator_passes": 1, "generator_replays": 1}
    if case == "wrap_small":    # Poseidon, arithmetic, reducing, ...
        assert lowered > len(host.generators) // 2
    _assert_same(got, want)


def test_replayed_proof_equals_the_worklist_proof():
    """A fib proof from a replayed witness equals, byte for byte, the proof
    from the worklist's witness under the same random stream."""
    builder, inputs = service_circuits.fib(PKG, steps=20, query_rounds=2)
    data = builder.build(device="cpu")
    rewind = _rewinder(data.prover_only)
    proofs = []
    for replays in (0, 1):
        rewind()
        tree = TimingTree(enabled=True)
        proof = data.prove(inputs(0, 1), timing=tree)
        assert tree.counts["generator_replays"] == replays
        proofs.append(serialization.serialize_proof_with_pis(proof,
                                                             data.common))
    assert proofs[0] == proofs[1]
    data.verify(proof)


# -- small circuits of their own ----------------------------------------------

def _product():
    """c = a * b, public; -> (builder, a, b, c)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=7)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    c = builder.mul(a, b)
    builder.register_public_input(c)
    return builder, a, b, c


def test_other_input_targets_record_a_new_plan():
    """Inputs that also set c record; their replay equals their worklist;
    the first inputs then record again."""
    builder, a, b, c = _product()
    host = builder.build_host()
    first = [(a, 3), (b, 5)]
    more = first + [(c, 15)]
    _, counts = _fixpoint(_pw(first), host)
    assert counts["generator_replays"] == 0
    _, counts = _fixpoint(_pw(first), host)
    assert counts["generator_replays"] == 1
    rewind = _rewinder(host)
    want, counts = _fixpoint(_pw(more), host)
    assert counts["generator_replays"] == 0
    rewind()
    got, counts = _fixpoint(_pw(more), host)
    assert counts["generator_replays"] == 1
    _assert_same(got, want)
    assert got.get(c) == 15
    _, counts = _fixpoint(_pw(first), host)
    assert counts["generator_replays"] == 0


class _Write(SimpleGenerator):
    """Writes f(x) to `out`."""

    def __init__(self, x, out, f):
        self.x, self.out, self.f = x, out, f

    def dependencies(self):
        return [self.x]

    def run_once(self, witness, out):
        out.append((self.out, self.f(witness.get(self.x))))


def test_conflicting_writes_raise_under_replay():
    """Two generators write x and x^2 to one partition: they agree at
    x = 1, so the plan records; at x = 2 the replay raises as the
    worklist does."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=7)
    x, y = builder.add_virtual_target(), builder.add_virtual_target()
    builder.add_simple_generator(_Write(x, y, lambda v: v))
    builder.add_simple_generator(_Write(x, y, lambda v: v * v))
    host = builder.build_host()
    _fixpoint(_pw([(x, 1)]), host)
    _, counts = _fixpoint(_pw([(x, 1)]), host)
    assert counts["generator_replays"] == 1
    with pytest.raises(AssertionError, match="set twice with different"):
        _fixpoint(_pw([(x, 2)]), host)
    _forget(host)
    with pytest.raises(AssertionError, match="set twice with different"):
        _fixpoint(_pw([(x, 2)]), host)


class _ByParity(SimpleGenerator):
    """Breaks the plan's invariant: writes x to `even` or to `odd` by the
    parity of x; with `twice`, an odd x writes `even`, then `odd`."""

    def __init__(self, x, even, odd, twice=False):
        self.x, self.even, self.odd, self.twice = x, even, odd, twice

    def dependencies(self):
        return [self.x]

    def run_once(self, witness, out):
        v = witness.get(self.x)
        if v % 2 == 0:
            out.append((self.even, v))
        elif self.twice:
            out += [(self.even, v), (self.odd, v)]
        else:
            out.append((self.odd, v))


class _ReadyByParity:
    """Breaks the plan's invariant: ready once x is set where x is even,
    and once y is set too where x is odd; writes x to `out`."""

    def __init__(self, x, y, out):
        self.x, self.y, self.out = x, y, out

    def watch_list(self):
        return [self.x, self.y]

    def run(self, witness, out):
        v = witness.try_get(self.x)
        if v is None or (v % 2 and not witness.is_set(self.y)):
            return False
        out.append((self.out, v))
        return True


def _breaking(kind):
    """-> (host, x, the target the witness ends with x in at an odd x)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=7)
    x, even, odd = (builder.add_virtual_target() for _ in range(3))
    if kind == "not_ready":
        y = builder.add_virtual_target()
        # runs ahead of y's generator where x is even
        builder.add_simple_generator(_ReadyByParity(x, y, odd))
        builder.add_simple_generator(_Write(x, y, lambda v: v + 1))
    else:
        builder.add_simple_generator(
            _ByParity(x, even, odd, twice=kind == "more_outputs"))
    # a generator after it, so that the plan has steps past the fault
    builder.add_simple_generator(_Write(x, builder.add_virtual_target(),
                                        lambda v: 2 * v))
    return builder.build_host(), x, odd


@pytest.mark.parametrize("kind", ["other_target", "more_outputs",
                                  "not_ready"])
def test_a_generator_off_the_plan_falls_back(kind):
    """Recorded at x = 2, proved at x = 3: the replay misses, the proof
    runs the worklist from a fresh witness and records; its witness equals
    a worklist's but for the random values, which it draws where the
    replay left the stream."""
    host, x, odd = _breaking(kind)
    _fixpoint(_pw([(x, 2)]), host)
    got, counts = _fixpoint(_pw([(x, 3)]), host)
    assert counts["generator_replays"] == 0
    assert counts["generator_passes"] >= 2      # the replay's, then more
    assert got.get(odd) == 3
    _forget(host)
    want, _ = _fixpoint(_pw([(x, 3)]), host)
    randoms = {got.rep_index(g.target) for g in host.generators
               if isinstance(g, RandomValueGenerator)}
    assert randoms and all(got.flags[r] for r in randoms)
    np.testing.assert_array_equal(got.set_reps, want.set_reps)
    assert [v for r, v in enumerate(got.as_list()) if r not in randoms] == \
        [v for r, v in enumerate(want.as_list()) if r not in randoms]
    _, counts = _fixpoint(_pw([(x, 3)]), host)
    assert counts["generator_replays"] == 1     # the new plan holds


def test_counters_of_a_recording_and_a_replay():
    """A recording: every generator runs at least once, in one pass or
    more, none on the tape, and `generator_replays` is 0; a replay: one run
    a generator, the lowered ones (c = a * b's) on the tape, one pass,
    `generator_replays` 1. Both spans open in each, inside the caller's
    scope."""
    builder, a, b, c = _product()
    host = builder.build_host()
    n = len(host.generators)
    for replays in (0, 1):
        tree = TimingTree(enabled=True)
        with tree.scope("run generators"):
            generate_partial_witness(_pw([(a, 3), (b, 5)]), host,
                                     host.common)
        counts = tree.span_counts["run generators"]
        assert counts["generator_replays"] == replays
        if replays:
            assert counts["generator_runs"] == n
            assert counts["generator_tape_runs"] == _tape_steps(host) >= 1
            assert counts["generator_passes"] == 1
        else:
            assert counts["generator_runs"] >= n
            assert counts["generator_tape_runs"] == 0
            assert counts["generator_passes"] >= 1
        assert [s.label for s in tree.spans if s.parent is not None] == \
            ["generator index", "generator passes"]


def test_other_generators_record_a_new_plan():
    """A plan runs the generators it was recorded over: where the circuit's
    list changes, the next proof records."""
    builder, a, b, c = _product()
    x = builder.add_virtual_target()
    host = builder.build_host()
    pairs = [(a, 3), (b, 5)]
    _fixpoint(_pw(pairs), host)
    host.generators = list(host.generators)     # the same generators
    _, counts = _fixpoint(_pw(pairs), host)
    assert counts["generator_replays"] == 1
    host.generators = host.generators + [_Write(a, x, lambda v: v + 1)]
    got, counts = _fixpoint(_pw(pairs), host)
    assert counts["generator_replays"] == 0
    assert got.get(x) == 4
