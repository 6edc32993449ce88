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
(`generate_partial_witness`). The replay runs the plan's lowered steps
(`iop/tape.py`) in the host C library, and the others in Python.
"""

from __future__ import annotations

from collections import defaultdict
from itertools import groupby

import numpy as np

from .. import host
from ..field import reference as ref
from ..utils import timing
from . import tape
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
        is_set = witness.flags.item
        rep = witness.rep_index
        if all(is_set(rep(t)) for t in self.deps_cached()):
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
    set, in `set_reps` order; `segments`, one step per generator in the
    order the worklist completed them, each run of consecutive lowered
    steps (`iop/tape.py`) gathered into one `tape.Tape`. A step is (its
    `run_once`, or its `run` where it is no SimpleGenerator; the
    representatives of its dependencies where it is a SimpleGenerator,
    else None; the targets it wrote, in order; the representative of
    each)."""

    __slots__ = ("generators", "inputs", "segments")

    def __init__(self, generators: list, inputs: np.ndarray, steps: list,
                 ops: list, size: int):
        """`ops`: each step's encoded tape op, or None; `size`: the
        representatives of the witness it was recorded in."""
        self.generators = list(generators)
        self.inputs = inputs
        self.segments = []
        for lowered, run in groupby(zip(steps, ops),
                                    key=lambda so: so[1] is not None):
            run = list(run)
            if lowered:
                self.segments.append(tape.Tape(
                    [x for _, op in run for x in op], [s for s, _ in run],
                    size))
            else:
                self.segments += [s for s, _ in run]

    def holds(self, generators: list, witness: PartitionWitness) -> bool:
        """Whether the plan was recorded over these generators, from inputs
        that set the representatives `witness` has set."""
        return np.array_equal(self.inputs, witness.set_reps) and \
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
    inputs = witness.set_reps.copy()
    rep = witness.rep_index
    # a pass requeues the watchers of the representatives set past
    # `cursor`, the inputs' too
    cursor = 0
    remaining = set(range(len(generators)))
    # First pass: try everything once (dependency-free generators fire here).
    queue = list(range(len(generators)))
    steps, ops = [], []
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
                targets = tuple(t for t, _ in buf)
                steps.append((
                    g.run_once if simple else g.run,
                    tuple(rep(t) for t in g.deps_cached()) if simple
                    else None, targets, tuple(reps)))
                lower = getattr(g, "tape_op", None) if simple else None
                ops.append(None if lower is None
                           else tape.encode(lower(), rep, targets))
        # requeue watchers of anything that changed
        seen = set()
        for r in witness.set_reps[cursor:].tolist():
            for gi in watchers.get(r, ()):
                if gi in remaining and gi not in seen:
                    seen.add(gi)
                    next_queue.append(gi)
        cursor = witness.num_set
        queue = next_queue
    return WitnessPlan(generators, inputs, steps, ops, witness.values.size), \
        runs, passes, len(remaining)


def _run_step(step, witness: PartitionWitness, out: list) -> bool:
    """One step of a plan, in Python: whether it ran as recorded (ready,
    writing the plan's targets), writing to its representatives as `set`
    would."""
    call, deps, targets, reps = step
    out.clear()
    if deps is None:
        if not call(witness, out):
            return False
    else:
        is_set = witness.flags.item
        if not all(is_set(d) for d in deps):
            return False
        call(witness, out)
    if len(out) != len(reps):
        return False
    set_rep = witness.set_rep
    for (t, v), target, r in zip(out, targets, reps):
        if t != target:
            return False
        set_rep(r, t, v)        # raises on a value set twice, as `set` does
    return True


def _replay(plan: WitnessPlan, witness: PartitionWitness
            ) -> tuple[int, int, bool]:
    """Run the plan's generators once each, in its order, writing to its
    representatives as `set` would: its tapes in the host C library where
    that is built, else every step in Python. -> (the runs, those of them
    the tape ran, whether the plan held): it fails where a generator was
    not ready or wrote other targets than the plan's, and leaves the
    witness half filled."""
    out: list = []
    lib = host.load()
    runs = tape_runs = 0
    for segment in plan.segments:
        is_tape = type(segment) is tape.Tape
        if is_tape and lib is not None:
            done, status = segment.run(lib, witness)
            runs += done
            tape_runs += done
            if status == tape.NOT_READY:
                return runs + 1, tape_runs, False
            if status != tape.OK:
                # a value set twice, or the generator's own check: its
                # Python step raises the error it raises off the tape
                _run_step(segment.steps[done], witness, out)
                raise RuntimeError(f"witness tape status {status} at a "
                                   "step its Python run accepts")
            continue
        for step in segment.steps if is_tape else (segment,):
            runs += 1
            if not _run_step(step, witness, out):
                return runs, tape_runs, False
    return runs, tape_runs, True


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
      (`run_once`, or `run` where it is no SimpleGenerator, or its op on
      the witness tape where its class lowers and the host C library is
      built: `iop/tape.py`), with no watch index and no second pass, and
      writes to the plan's representatives, with `set`'s check of a
      partition set twice.
    - Fallback: a replayed generator that is not ready, or that writes
      other targets than the plan's, makes the proof run the worklist, from
      a fresh witness, and record. Its random values are drawn where the
      replay left the stream.

    For the same inputs and random stream a replay's witness equals the
    worklist's, `set_reps` order included.

    Under the thread's active TimingTree, two host spans: `generator index`
    (the match of the plan and, on a recording, the watch index) and
    `generator passes` (the replay or the worklist), and four counters,
    added once at the end: `generator_runs`, the calls of a generator's
    `run` or `run_once`, retries included, and the steps the tape ran;
    `generator_tape_runs`, the steps the tape ran (0 on a recording);
    `generator_passes`, the passes of the worklist (1 for a replay);
    `generator_replays`, 1 where the proof replayed, else 0."""
    layout = PartitionLayout.of(prover_data, common)
    generators = prover_data.generators
    witness = _with_inputs(layout, common, inputs)
    runs = tape_runs = passes = replayed = never = 0

    with timing.scope("generator index"):
        plan = getattr(prover_data, "_witness_plan", None)
        if plan is None or not plan.holds(generators, witness):
            plan = None
            watchers = _watchers(witness, generators)

    with timing.scope("generator passes"):
        if plan is not None:
            runs, tape_runs, held = _replay(plan, witness)
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
    timing.count("generator_tape_runs", tape_runs)
    timing.count("generator_passes", passes)
    timing.count("generator_replays", replayed)
    assert not never, \
        f"{never} generators never ran (missing witness inputs?)"
    return witness
