#!/usr/bin/env python3
"""The port's spans and counts held against what the card shows, for each
cell of the benchmark (`BENCHMARK.json`), at its configuration's size.

    python3 scripts/torch_trace_audit.py --out <file.json> [--cells a,b]
        [--pairs 4]

For each cell, after a cold and a warm call under a disabled tree:
- `host_reads`: one call under an enabled TimingTree with
  `torch.cuda.set_sync_debug_mode("warn")` on; every synchronizing call
  PyTorch reports, but those of `utils/timing.py`'s own synchronizes, is
  set beside the tree's `host_reads`, in total and by the innermost open
  span, with the program's sites of any the counter missed or counted
  without a synchronize;
- idle by span: one call under the benchmark's profiler capture
  (`benchmark/tracing.Capture`) and an enabled tree: the card's idle
  seconds inside each span, each span's self idle (not under one of its
  child spans), the idle outside every depth-0 span, and how far each
  span's start and end lie from its `record_function` range, and the
  longest idle stretches outside every depth-0 span;
- idle by proof: in a batch, the idle inside each proof's spans (those
  that carry the proof's index `b`);
- launches by span, in the same capture: the card's kernels a proof, by
  the innermost scope open when each starts, split into the field
  arithmetic's (csrc/field.cu), the other hand kernels' (K1-K3, K6, K7)
  and PyTorch's own (aten glue), with the aten kernels that launch most;
- the cost of tracing: `--pairs` pairs of calls on the same inputs, one
  untraced and one traced, the side that runs first alternating, with
  the median of the pairs' ratios and its quartiles.

One JSON object goes to `--out`, one summary line a cell to standard
output. With
`--device cpu --small` it runs at the harness tests' sizes on the CPU
(there is no synchronize to audit there).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import threading
import time
import traceback
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"recursion_leaf_d14": {"degree_bits": 6},
         "starky_fib_r20": {"degree_bits": 8}}
SEED = 2 ** 31 + 1913
OWN_SYNC = os.path.join("utils", "timing.py")
# the profiler's names of the hand kernels' CUDA functions
FIELD_KERNELS = re.compile(r"\bfield_(binary|ext)_kernel\b")
HAND_KERNELS = re.compile(r"\bntt_(row|tiles|columns)\b|"
                          r"\b(permute|merkle|hash_leaves(_lanes)?)_kernel\b")


def kernel_kind(name: str) -> str:
    if FIELD_KERNELS.search(name):
        return "field"
    return "hand" if HAND_KERNELS.search(name) else "aten"


def launches_by_span(data, proofs: int) -> dict:
    """The capture's kernels a proof by the innermost scope open when each
    starts on the card, by kind, and the aten kernels that launch most."""
    by_span: dict = {}
    aten = Counter()
    for name, start, _ in data.kernels:
        kind = kernel_kind(name)
        by_span.setdefault(data.open_scope(start), Counter())[kind] += 1
        if kind == "aten":
            aten[name[:160]] += 1
    total = sum(by_span.values(), Counter())
    return {"per_proof": {k: v / proofs for k, v in total.items()},
            "by_span": {label: {k: v / proofs for k, v in c.items()}
                        for label, c in sorted(
                            by_span.items(),
                            key=lambda kv: -kv[1]["aten"] - kv[1]["field"])},
            "aten_most": [(name, n / proofs)
                          for name, n in aten.most_common(15)]}


def _site(stack) -> str:
    """The innermost frame of the program (the timing module aside) and
    the frame that called it."""
    frames = [f for f in stack if "plonky2_tpu_torch" in f.filename
              and not f.filename.endswith(OWN_SYNC)]
    if not frames:
        return "outside the program"
    inner = frames[-1]
    where = f"{os.path.relpath(inner.filename, ROOT)}:{inner.name}"
    if len(frames) > 1:
        outer = frames[-2]
        where += (f" <- {os.path.relpath(outer.filename, ROOT)}:"
                  f"{outer.lineno}")
    return where


def _open_label(timing) -> str | None:
    tree = timing._ACTIVE.tree
    return tree._open[-1][1] if tree is not None and tree._open else None


def audit_reads(call, timing) -> dict:
    """One call with PyTorch's sync debug mode on: the synchronizes it
    reports against the tree's host_reads."""
    import torch
    syncs, counted, outside = [], [], []
    count = timing.count

    def counting(name, n=1):
        if name == "host_reads":
            counted.append((_open_label(timing),
                            _site(traceback.extract_stack())))
        count(name, n)

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            # another warning (set_sync_debug_mode warns that it is beta)
            return shown(message, category, filename, lineno, file, line)
        stack = traceback.extract_stack()
        own = any(f.filename.endswith(OWN_SYNC) for f in stack)
        syncs.append((own, _open_label(timing), _site(stack)))
        if syncs[-1][2] == "outside the program":
            outside.append([threading.current_thread().name] + [
                f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                for f in stack[-8:-1]])

    shown = warnings.showwarning
    timing.count = counting
    warnings.showwarning = show
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tree = call(True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        timing.count = count
        warnings.showwarning = shown
    reported = [(label, site) for own, label, site in syncs if not own]
    by_span = Counter(label for label, _ in reported)
    missed = Counter(site for _, site in reported) - Counter(
        site for _, site in counted)
    extra = Counter(site for _, site in counted) - Counter(
        site for _, site in reported)
    return {"host_reads": tree.counts.get("host_reads", 0),
            "synchronizes": len(reported),
            "own_synchronizes": sum(own for own, _, _ in syncs),
            "host_reads_by_span": {k: v.get("host_reads", 0)
                                   for k, v in tree.span_counts.items()},
            "synchronizes_by_span": dict(by_span),
            "missed_sites": dict(missed), "uncalled_for_sites": dict(extra),
            "outside_the_program": outside}


def _overlap(a0: int, a1: int, gaps: list) -> int:
    return sum(max(0, min(a1, e) - max(a0, s)) for s, e in gaps)


def idle_by_span(call, proofs: int) -> dict:
    """One call under the benchmark's capture: idle seconds inside each
    span, by label, and each label's self idle."""
    from benchmark.tracing import Capture
    with Capture() as capture:
        tree = call(True)
    data = capture.data(proofs, {}, {s.label for s in tree.spans})
    gaps = data.idle_gaps()
    idle_total = sum(e - s for s, e in gaps)
    children: dict = {}
    spans_by_id = {s.id: s for s in tree.spans}
    for s in tree.spans:
        children.setdefault(s.parent, []).append(s)
    inside, self_idle = Counter(), Counter()
    for s in tree.spans:
        idle = _overlap(s.start_ns, s.end_ns, gaps)
        inside[s.label] += idle
        self_idle[s.label] += idle - sum(
            _overlap(c.start_ns, c.end_ns, gaps)
            for c in children.get(s.id, []))
    by_proof = Counter()
    for s in tree.spans:
        if s.b is not None and (s.parent is None
                                or spans_by_id[s.parent].b is None):
            by_proof[s.b] += _overlap(s.start_ns, s.end_ns, gaps)
    top = [s for s in tree.spans if s.parent is None]
    outside = idle_total - sum(_overlap(s.start_ns, s.end_ns, gaps)
                               for s in top)
    # the longest idle stretches outside every depth-0 span, each with the
    # depth-0 spans before and after it
    top = sorted(top, key=lambda s: s.start_ns)
    pieces = []
    for g0, g1 in gaps:
        at = g0
        for s in top + [None]:
            end = g1 if s is None else min(g1, s.start_ns)
            if end > at:
                before = [t.label for t in top if t.end_ns <= at]
                pieces.append((end - at, before[-1] if before else None,
                               None if s is None else s.label))
            if s is not None:
                at = max(at, s.end_ns)
            if at >= g1:
                break
    # each span against its record_function range (matched in order)
    ranges: dict = {}
    for label, start, end in sorted(data.scopes, key=lambda r: r[1]):
        ranges.setdefault(label, []).append((start, end))
    skew = 0
    for label, spans in _by_label(tree.spans).items():
        for s, (start, end) in zip(spans, ranges.get(label, [])):
            skew = max(skew, abs(s.start_ns - start), abs(s.end_ns - end))
    ns = 1e-9
    return {"launches": launches_by_span(data, proofs),
            "window_s": data.window_s, "busy_s": data.busy_s(),
            "idle_s": idle_total * ns, "outside_s": outside * ns,
            "idle_in_span_s": {k: v * ns for k, v in inside.most_common()},
            "self_idle_s": {k: v * ns for k, v in self_idle.most_common()},
            "idle_by_proof_s": {b: v * ns for b, v in sorted(
                by_proof.items())},
            "outside_longest": [(d * ns, a, b) for d, a, b in sorted(
                pieces, key=lambda p: -p[0])[:8]],
            "span_vs_range_max_ns": skew,
            "spans_without_range": sum(
                max(0, len(v) - len(ranges.get(k, [])))
                for k, v in _by_label(tree.spans).items())}


def _by_label(spans) -> dict:
    out: dict = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        out.setdefault(s.label, []).append(s)
    return out


def tracing_cost(call, pairs: int) -> dict:
    """`pairs` pairs of calls on the same inputs, untraced and traced, the
    side that runs first alternating from pair to pair: each side's
    seconds, each pair's traced/untraced ratio, and the ratios' median
    and quartile spread."""
    import torch
    off, on, ratios = [], [], []
    for i in range(pairs):
        seconds = {}
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(traced)
            seconds[traced] = time.perf_counter() - t0
        off.append(seconds[False])
        on.append(seconds[True])
        ratios.append(seconds[True] / seconds[False])
    q1, _, q3 = (statistics.quantiles(ratios, n=4) if pairs > 1
                 else (ratios[0],) * 3)
    return {"off_s": off, "on_s": on, "first": ["off", "on"] * (pairs // 2)
            + ["off"] * (pairs % 2),
            "median_off_s": statistics.median(off),
            "median_on_s": statistics.median(on),
            "cost_pct": 100 * (statistics.median(ratios) - 1),
            "cost_pct_quartiles": [100 * (q1 - 1), 100 * (q3 - 1)]}


def audit_cell(cell: str, device: str, small: bool, pairs: int) -> dict:
    import numpy as np
    import torch

    from benchmark import load
    from plonky2_tpu_torch.utils import timing
    spec = load.data("cells", cell)
    cfg = load.data("configs", spec["config"])
    if small:
        cfg.update(SMALL[spec["config"]])
    per_call = int(load.data("traffic", spec["traffic"])["proofs_per_call"])
    drive = load.module("configs", spec["config"])
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    system = drive.System(cfg, device, SEED)
    prepared = system.prepare([drive.draw(rng, cfg)
                               for _ in range(per_call)])

    def call(traced: bool):
        tree = timing.TimingTree(enabled=traced)
        system.prove(prepared, tree)
        return tree

    for _ in range(2):
        call(False)
    out = {"cell": cell, "proofs_per_call": per_call,
           "setup_s": time.perf_counter() - t0}
    before = timing.totals()
    tree = call(True)
    out["counts"] = tree.counts
    out["host_reads_by_span"] = {k: v.get("host_reads", 0)
                                 for k, v in tree.span_counts.items()}
    out["spans"] = len(tree.spans)
    out["labels"] = sorted({s.label for s in tree.spans})
    if torch.device(device).type == "cuda":
        out["reads"] = audit_reads(call, timing)
    out["idle"] = idle_by_span(call, per_call)
    out["cost"] = tracing_cost(call, pairs)
    after = timing.totals()
    out["totals_delta"] = {k: after.get(k, 0) - before.get(k, 0)
                           for k in after}
    system.close()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", default=None,
                        help="cells, comma-separated (default: every cell)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    import torch

    from benchmark import load
    cells = (args.cells.split(",") if args.cells else
             [w["name"] for w in load.benchmark_json()["workloads"]])
    result = {"device": (torch.cuda.get_device_name(0)
                         if torch.device(args.device).type == "cuda"
                         else args.device), "cells": []}
    for cell in cells:
        r = audit_cell(cell, args.device, args.small, args.pairs)
        result["cells"].append(r)
        reads = r.get("reads", {})
        idle = r["idle"]
        print(json.dumps({
            "cell": cell, "host_reads": r["counts"].get("host_reads"),
            "synchronizes": reads.get("synchronizes"),
            "missed": reads.get("missed_sites"),
            "uncalled_for": reads.get("uncalled_for_sites"),
            "idle_s": idle["idle_s"], "outside_s": idle["outside_s"],
            "launches_per_proof": idle["launches"]["per_proof"],
            "skew_ns": idle["span_vs_range_max_ns"],
            "cost_pct": r["cost"]["cost_pct"],
            "cost_pct_quartiles": r["cost"]["cost_pct_quartiles"]}),
            flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
