"""Witness generators + the fixpoint scheduler.

Reference: plonky2/src/iop/generator.rs — WitnessGenerator trait (watch_list +
run), generate_partial_witness:26-100 (worklist fixpoint: run all generators,
re-queue those watching newly-populated representatives, assert completion).

A generator is a host-side object: `watch_list()` returns targets whose
availability may unblock it; `run(witness)` returns True when done (having
written its outputs into the witness) or False to be retried once a watched
partition is populated.
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


def generate_partial_witness(inputs: PartialWitness, prover_data,
                             common) -> PartitionWitness:
    """Worklist fixpoint over generators (reference: generator.rs:26-100).

    Under the thread's active TimingTree, two host spans: `generator index`
    (the watchers of each representative) and `generator passes` (the
    worklist), and two counters, added once at the end: `generator_runs`,
    the calls of a generator's `run`, retries included, and
    `generator_passes`, the passes of the worklist."""
    witness = PartitionWitness(PartitionLayout.of(prover_data, common),
                               common.config.num_wires, common.degree)
    generators = prover_data.generators

    # Index generators by the representative of each watched target.
    with timing.scope("generator index"):
        watchers: dict[int, list[int]] = defaultdict(list)
        for gi, g in enumerate(generators):
            for t in g.watch_list():
                watchers[witness.rep_index(t)].append(gi)

    for t, v in inputs.values.items():
        witness.set(t, v)
    # the representatives set so far, in order; a pass requeues the
    # watchers of those past `cursor`
    set_reps = witness.set_reps
    cursor = 0

    remaining = set(range(len(generators)))
    # First pass: try everything once (dependency-free generators fire here).
    queue = list(range(len(generators)))
    buf: list = []
    runs = passes = 0
    with timing.scope("generator passes"):
        while queue:
            passes += 1
            next_queue: list[int] = []
            for gi in queue:
                if gi not in remaining:
                    continue
                buf.clear()
                runs += 1
                if generators[gi].run(witness, buf):
                    remaining.discard(gi)
                    for t, v in buf:
                        witness.set(t, v)
            # requeue watchers of anything that changed
            seen = set()
            for r in set_reps[cursor:]:
                for gi in watchers.get(r, ()):
                    if gi in remaining and gi not in seen:
                        seen.add(gi)
                        next_queue.append(gi)
            cursor = len(set_reps)
            queue = next_queue
    timing.count("generator_runs", runs)
    timing.count("generator_passes", passes)

    assert not remaining, \
        f"{len(remaining)} generators never ran (missing witness inputs?)"
    return witness
