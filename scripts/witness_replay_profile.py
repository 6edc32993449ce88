"""Profile the witness fixpoint's replay and the wire matrix of the
recursion_wrap_d13 benchmark cell's wrap, by generator class.

Proves one leaf of the cell's inner configuration (its `degree_bits` may be
lowered with --leaf-degree-bits), lays the wrap out on the host only
(`build_host()`), records its plan, then times --replays replays of the
fixpoint (`generate_partial_witness`) and of `wire_matrix` each. Last, it
records again with every generator class's `run_once` and `run` under a
timer and replays once more: the per-class rows give the steps, the values
written and the milliseconds of the Python steps, and one row the witness
tape's segments (`iop/tape.py`) with the steps of each class they ran.
The timers add about a microsecond a Python step. Where the tree has the
tape, each lowered class's ops also run alone, as one tape over a copy of
a finished witness with their outputs unset (`tape_alone_by_class`).

Runs on any tree of this repository, with or without the witness tape:

    python scripts/witness_replay_profile.py --device cuda \\
        --out witness_profile.json
    python scripts/witness_replay_profile.py --device cpu \\
        --leaf-degree-bits 10      # about a minute of CPU proving
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import platform
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _timed(fn, key, table):
    def run(self, witness, out, *rest):
        n = len(out)
        t0 = time.perf_counter()
        try:
            return fn(self, witness, out, *rest)
        finally:
            row = table[key(self)]
            row[0] += 1
            row[1] += len(out) - n
            row[2] += time.perf_counter() - t0
    return run


def _patch_classes(generators, table):
    """Put every generator class's `run_once` and `run` under a timer; the
    rows of `table` are [steps, values, seconds] by class name."""
    name = lambda g: type(g).__name__
    for cls in {type(g) for g in generators}:
        for attr in ("run_once", "run"):
            fn = cls.__dict__.get(attr)
            if fn is not None:
                setattr(cls, attr, _timed(fn, name, table))


def _tape_by_class(tape_mod, host, finished) -> list:
    """Each lowered class's ops of the plan, in its order, run alone as one
    tape over a copy of the finished witness with their outputs unset:
    [class, steps, values, ms]."""
    from plonky2_tpu_torch import host as host_lib
    from plonky2_tpu_torch.iop.witness import PartitionWitness
    lib = host_lib.load()
    plan = host._witness_plan
    ops, outs = collections.defaultdict(list), collections.defaultdict(list)
    # each representative goes to the class of the step that set it first
    seen = set(plan.inputs.tolist())
    for segment in plan.segments:
        steps = segment.steps if isinstance(segment, tape_mod.Tape) \
            else [segment]
        for call, _, targets, reps in steps:
            g = call.__self__
            name = type(g).__name__
            if isinstance(segment, tape_mod.Tape):
                ops[name].append(
                    tape_mod.encode(g.tape_op(), finished.rep_index, targets))
                outs[name] += [r for r in reps if r not in seen]
            seen.update(reps)
    rows = []
    for name in ops:
        w = PartitionWitness(finished.layout, finished.num_wires,
                             finished.degree)
        w.values[:] = finished.values
        w.flags[:] = finished.flags
        w.flags[list(outs[name])] = 0
        run = tape_mod.Tape([x for op in ops[name] for x in op], ops[name],
                             w.values.size)
        t = time.perf_counter()
        done, status = run.run(lib, w)
        seconds = time.perf_counter() - t
        assert (done, status) == (len(ops[name]), tape_mod.OK), (name, done)
        rows.append([name, done, w.num_set, seconds * 1e3])
    return sorted(rows, key=lambda r: -r[3])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--leaf-degree-bits", type=int, default=None)
    parser.add_argument("--replays", type=int, default=10)
    parser.add_argument("--seed", type=int, default=2718281828)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from benchmark import load
    from plonky2_tpu_torch.iop import generator as gen_mod
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.iop.witness import wire_matrix
    from plonky2_tpu_torch.recursion.verifier import wrap_circuit
    from plonky2_tpu_torch.utils.timing import TimingTree

    cfg = load.data("configs", "recursion_wrap_d13")
    inner_cfg = dict(cfg["inner_config"])
    if args.leaf_degree_bits is not None:
        inner_cfg["degree_bits"] = args.leaf_degree_bits
    leaf_mod = load.module("configs", "recursion_leaf_d14")
    t0 = time.perf_counter()
    leaf = leaf_mod.System(inner_cfg, args.device, args.seed)
    rng = np.random.default_rng(args.seed)
    pw = leaf.prepare([leaf_mod.draw(rng, inner_cfg)])[0]
    inner = leaf.data.prove(pw, timing=TimingTree(enabled=False))
    builder, witness = wrap_circuit(leaf.data, register_inner=True,
                                    config=leaf_mod.circuit_config(cfg))
    host = builder.build_host()
    setup_s = time.perf_counter() - t0

    def fixpoint():
        tree = TimingTree(enabled=True)
        inputs = witness(inner)
        t = time.perf_counter()
        with tree.scope("run generators"):
            w = generate_partial_witness(inputs, host, host.common)
        t_fix = time.perf_counter() - t
        t = time.perf_counter()
        wire_matrix([w])
        return w, t_fix, time.perf_counter() - t, tree.counts

    t = time.perf_counter()
    _, _, _, record_counts = fixpoint()
    record_s = time.perf_counter() - t
    fix_ms, matrix_ms, counts = [], [], None
    for _ in range(args.replays):
        w, t_fix, t_matrix, counts = fixpoint()
        fix_ms.append(t_fix * 1e3)
        matrix_ms.append(t_matrix * 1e3)

    tape_mod = getattr(gen_mod, "tape", None)
    by_class = _tape_by_class(tape_mod, host, w) if tape_mod else []

    # the per-class profile: timers on every class, a new recording, a
    # replay
    table = collections.defaultdict(lambda: [0, 0, 0.0])
    _patch_classes(host.generators, table)
    tape_row = [0, 0, 0.0]
    tape_classes: collections.Counter = collections.Counter()
    if tape_mod is not None:
        run = tape_mod.Tape.run

        def timed_run(self, lib, w):
            n = w.num_set
            t = time.perf_counter()
            done, status = run(self, lib, w)
            tape_row[2] += time.perf_counter() - t
            tape_row[0] += done
            tape_row[1] += w.num_set - n
            tape_classes.update(type(s[0].__self__).__name__
                                for s in self.steps[:done])
            return done, status
        tape_mod.Tape.run = timed_run
    host._witness_plan = None
    fixpoint()
    table.clear()
    w, t_fix, _, _ = fixpoint()
    rows = sorted(([k, *v] for k, v in table.items()), key=lambda r: -r[3])
    result = {
        "host": platform.processor() or platform.machine(),
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(0)
                   if args.device == "cuda" else args.device),
        "leaf_degree_bits": inner_cfg["degree_bits"],
        "generators": len(host.generators),
        "set_representatives": int(len(w.set_reps)),
        "setup_s": setup_s, "record_s": record_s,
        "record_counts": record_counts, "replay_counts": counts,
        "replay_ms": fix_ms, "replay_ms_median": statistics.median(fix_ms),
        "wire_matrix_ms": matrix_ms,
        "wire_matrix_ms_median": statistics.median(matrix_ms),
        "profiled_replay_ms": t_fix * 1e3,
        "python_steps": [{"class": k, "steps": n, "values": v,
                          "ms": s * 1e3, "us_each": s * 1e6 / max(n, 1)}
                         for k, n, v, s in rows],
        "tape": {"steps": tape_row[0], "values": tape_row[1],
                 "ms": tape_row[2] * 1e3,
                 "steps_by_class": dict(tape_classes)},
        "tape_alone_by_class": by_class,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
