"""Witness generators + the fixpoint scheduler.

Reference: plonky2/src/iop/generator.rs — WitnessGenerator trait (watch_list +
run), generate_partial_witness:26-100 (worklist fixpoint: run all generators,
re-queue those watching newly-populated representatives, assert completion).

A generator is a host-side object: `watch_list()` returns targets whose
availability may unblock it; `run(witness)` returns True when done (having
written its outputs into the witness) or False to be retried once a watched
partition is populated.

The worklist runs at a circuit's first proof, and records a plan: the
order in which the generators completed and the representatives each one
wrote. Later proofs whose inputs set the same representatives replay it,
each generator once, and fall back to the worklist where a generator does
not do as recorded. The plan rests on an invariant of every generator: its
readiness and the targets it writes do not depend on values
(`generate_partial_witness`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..field import reference as ref
from ..utils import timing
from .witness import PartialWitness, PartitionLayout, PartitionWitness


class SimpleGenerator:
    """Runs once, when every dependency is available."""

    def dependencies(self) -> list:
        raise NotImplementedError

    def run_once(self, witness: PartitionWitness, out: list) -> None:
        """Append (target, value) pairs to `out`."""
        raise NotImplementedError

    # -- WitnessGenerator surface
    def watch_list(self) -> list:
        return self.deps_cached()

    def deps_cached(self) -> list:
        """dependencies() is pure but rebuilds its list per call; the
        fixpoint re-polls blocked generators, so cache it."""
        deps = getattr(self, "_deps", None)
        if deps is None:
            deps = self._deps = self.dependencies()
        return deps

    def run(self, witness: PartitionWitness, out: list) -> bool:
        values = witness.values
        rep = witness.rep_index
        if all(values[rep(t)] is not None for t in self.deps_cached()):
            self.run_once(witness, out)
            return True
        return False


class ConstantGenerator(SimpleGenerator):
    """Fills one wire with a build-time constant
    (reference: iop/generator.rs ConstantGenerator)."""

    def __init__(self, row: int, constant_index: int, wire_index: int,
                 constant: int = 0):
        self.row = row
        self.constant_index = constant_index
        self.wire_index = wire_index
        self.constant = constant

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        out.append((("w", self.row, self.wire_index), self.constant))


class RandomValueGenerator(SimpleGenerator):
    """Fills one target with a uniform random field element
    (reference: iop/generator.rs RandomValueGenerator)."""

    def __init__(self, target, rng):
        self.target = target
        self.rng = rng

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        out.append((self.target, int(self.rng.integers(0, ref.ORDER,
                                                       dtype=np.uint64))))


class WitnessPlan:
    """One circuit's recorded fixpoint, kept on its prover data (host
    memory only, never serialized): `generators`, a copy of the list it
    was recorded over; `inputs`, the representatives the partial witness
    set, in `set_reps` order; `steps`, one per generator in the order the
    worklist completed them: (its `run_once`, or its `run` where it is no
    SimpleGenerator; whether it is one; the targets it wrote, in order;
    the representative of each)."""

    __slots__ = ("generators", "inputs", "steps")

    def __init__(self, generators: list, inputs: list, steps: list):
        self.generators = list(generators)
        self.inputs = inputs
        self.steps = steps

    def holds(self, generators: list, witness: PartitionWitness) -> bool:
        """Whether the plan was recorded over these generators, from inputs
        that set the representatives `witness` has set."""
        return self.inputs == witness.set_reps and \
            self.generators == generators


def _with_inputs(layout, common, inputs: PartialWitness) -> PartitionWitness:
    witness = PartitionWitness(layout, common.config.num_wires,
                               common.degree)
    for t, v in inputs.values.items():
        witness.set(t, v)
    return witness


def _watchers(witness: PartitionWitness, generators) -> dict:
    """The generators watching each representative."""
    watchers: dict[int, list[int]] = defaultdict(list)
    rep = witness.rep_index
    for gi, g in enumerate(generators):
        for t in g.watch_list():
            watchers[rep(t)].append(gi)
    return watchers


def _worklist(witness: PartitionWitness, generators, watchers: dict):
    """The worklist fixpoint; -> (the WitnessPlan of this run, its runs,
    its passes, the generators that never ran)."""
    inputs = list(witness.set_reps)
    set_reps = witness.set_reps
    rep = witness.rep_index
    # a pass requeues the watchers of the representatives set past
    # `cursor`, the inputs' too
    cursor = 0
    remaining = set(range(len(generators)))
    # First pass: try everything once (dependency-free generators fire here).
    queue = list(range(len(generators)))
    steps = []
    buf: list = []
    runs = passes = 0
    while queue:
        passes += 1
        next_queue: list[int] = []
        for gi in queue:
            if gi not in remaining:
                continue
            buf.clear()
            runs += 1
            g = generators[gi]
            if g.run(witness, buf):
                remaining.discard(gi)
                reps = []
                for t, v in buf:
                    r = rep(t)
                    witness.set_rep(r, t, v)
                    reps.append(r)
                simple = isinstance(g, SimpleGenerator)
                steps.append((g.run_once if simple else g.run, simple,
                              tuple(t for t, _ in buf), tuple(reps)))
        # requeue watchers of anything that changed
        seen = set()
        for r in set_reps[cursor:]:
            for gi in watchers.get(r, ()):
                if gi in remaining and gi not in seen:
                    seen.add(gi)
                    next_queue.append(gi)
        cursor = len(set_reps)
        queue = next_queue
    return WitnessPlan(generators, inputs, steps), runs, passes, \
        len(remaining)


def _replay(plan: WitnessPlan, witness: PartitionWitness
            ) -> tuple[int, bool]:
    """Run the plan's generators once each, in its order, writing to its
    representatives as `set` would. -> (the runs, whether the plan held):
    it fails where a generator was not ready or wrote other targets than
    the plan's, and leaves the witness half filled."""
    values = witness.values
    append = witness.set_reps.append
    order = ref.ORDER
    out: list = []
    for n, (call, simple, targets, reps) in enumerate(plan.steps, 1):
        out.clear()
        if not (call(witness, out) or simple) or len(out) != len(reps):
            return n, False
        for (t, v), target, r in zip(out, targets, reps):
            if t != target:
                return n, False
            v %= order
            prev = values[r]
            if prev is None:
                values[r] = v
                append(r)
            elif prev != v:
                witness.set_rep(r, t, v)    # raises, as `set` does
    return len(plan.steps), True


def generate_partial_witness(inputs: PartialWitness, prover_data,
                             common) -> PartitionWitness:
    """The witness fixpoint (reference: generator.rs:26-100), recorded once
    per circuit and replayed.

    The plan rests on one invariant of every generator: when it becomes
    ready (its fixed dependencies are set) and which targets it writes do
    not depend on values. So for one set of input representatives the
    worklist completes the generators in one order, each writing the same
    representatives, on every proof.

    - Record: where the circuit has no plan, or the inputs set other
      representatives (in `set_reps` order) than its plan's, or its
      generators are not those of the plan, the worklist runs, and its
      completion order and each generator's targets and representatives
      become the circuit's plan (`WitnessPlan`, on `prover_data`, replaced
      on every recording).
    - Replay: otherwise each generator runs once, in the plan's order
      (`run_once`, or `run` where it is no SimpleGenerator), with no watch
      index and no second pass, and writes to the plan's representatives,
      with `set`'s check of a partition set twice.
    - Fallback: a replayed generator that is not ready, or that writes
      other targets than the plan's, makes the proof run the worklist, from
      a fresh witness, and record. Its random values are drawn where the
      replay left the stream.

    For the same inputs and random stream a replay's witness equals the
    worklist's, `set_reps` order included.

    Under the thread's active TimingTree, two host spans: `generator index`
    (the match of the plan and, on a recording, the watch index) and
    `generator passes` (the replay or the worklist), and three counters,
    added once at the end: `generator_runs`, the calls of a generator's
    `run` or `run_once`, retries included; `generator_passes`, the passes
    of the worklist (1 for a replay); `generator_replays`, 1 where the
    proof replayed, else 0."""
    layout = PartitionLayout.of(prover_data, common)
    generators = prover_data.generators
    witness = _with_inputs(layout, common, inputs)
    runs = passes = replayed = never = 0

    with timing.scope("generator index"):
        plan = getattr(prover_data, "_witness_plan", None)
        if plan is None or not plan.holds(generators, witness):
            plan = None
            watchers = _watchers(witness, generators)

    with timing.scope("generator passes"):
        if plan is not None:
            runs, held = _replay(plan, witness)
            passes, replayed = 1, int(held)
            if not held:
                witness = _with_inputs(layout, common, inputs)
                watchers = _watchers(witness, generators)
        if not replayed:
            plan, more_runs, more_passes, never = _worklist(
                witness, generators, watchers)
            runs += more_runs
            passes += more_passes
            if not never:
                prover_data._witness_plan = plan
    timing.count("generator_runs", runs)
    timing.count("generator_passes", passes)
    timing.count("generator_replays", replayed)
    assert not never, \
        f"{never} generators never ran (missing witness inputs?)"
    return witness
