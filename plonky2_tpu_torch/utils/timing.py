"""TimingTree — hierarchical scoped timer (reference: util/timing.rs
TimingTree:8, the timed! macro :179).

Each scope is a `torch.profiler.record_function` range, so a profiler run
shows the prover's phases on the card's timeline, and its host seconds are
kept in `records` as (depth, label, seconds) in the order the scopes close.
A scope given a CUDA `device` ends in a synchronize of that device, so its
seconds include the device work queued inside it; a disabled tree adds no
synchronize. Enabled when constructed with enabled=True or when
PLONKY2_TPU_TIMING or PLONKY2_TPU_PROFILE is set; PLONKY2_TPU_TIMING also
prints each scope as it closes.

An enabled tree is one call: it keeps each closed scope in `spans` as a
`Span` (id, parent id, label, start_ns, end_ns on `time.time_ns()`, the
clock of torch.profiler's events, stamped just outside and just inside
the scope's range, and the proof index `b` of a batch's per-proof scope,
inherited by the scopes inside it). While it has a scope open it is the
current thread's active tree, so code deep in the prover opens scopes
with the module's `scope(label, device)` and adds to counters with
`count(name, n)` without being handed the tree; both do nothing where
the thread has no active tree (a disabled tree never becomes active), at
the cost of one thread-local read. `counts` holds {name: n} over the
call and `span_counts` {label: {name: n}} by the innermost scope open at
each count; `totals()` sums the counts of every enabled tree of the
process. The counters:
- `proofs`: the proofs proved under the tree;
- `host_reads`: each point where the host waits on the card's queue, on
  every device alike so that a CPU run counts what the card would: a read
  of a tensor to the host (`goldilocks.to_u64`, `torch.nonzero`, `int` of
  an element) and an upload that PyTorch ends in a stream synchronize (a
  blocking copy from pageable host memory: `goldilocks.from_u64`,
  `torch.as_tensor` of a numpy array onto the device).

Profiler capture: with PLONKY2_TPU_PROFILE=<dir> set, the first enabled tree
starts a `torch.profiler.profile` of the host and, where there is a card, of
the card; `stop_profiler()` stops it and writes its Chrome trace (.json)
under <dir>, in which every scope is a named range on both timelines.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch

# the process's one capture under PLONKY2_TPU_PROFILE: (profile, its dir)
_PROFILE = None


def _maybe_start_profiler() -> None:
    global _PROFILE
    out_dir = os.environ.get("PLONKY2_TPU_PROFILE")
    if not out_dir or _PROFILE is not None:
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profile = torch.profiler.profile(activities=activities)
    profile.start()
    _PROFILE = (profile, out_dir)


def stop_profiler() -> str | None:
    """Stop the PLONKY2_TPU_PROFILE capture and write its Chrome trace;
    returns the trace's path, or None when no capture was running."""
    global _PROFILE
    if _PROFILE is None:
        return None
    (profile, out_dir), _PROFILE = _PROFILE, None
    profile.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"plonky2_tpu_torch_{os.getpid()}_"
                                 f"{time.time_ns()}.json")
    profile.export_chrome_trace(path)
    return path


class Span(NamedTuple):
    id: int
    parent: int | None      # the span open when this one began
    label: str
    start_ns: int           # time.time_ns(), torch.profiler's clock
    end_ns: int
    b: int | None           # the proof of a batch the span belongs to


class _Active(threading.local):
    tree = None             # the thread's active TimingTree


_ACTIVE = _Active()
_NO_SCOPE = nullcontext()
_TOTALS: dict = {}
_TOTALS_LOCK = threading.Lock()


def scope(label: str, device=None, b: int | None = None):
    """A scope of the thread's active tree (`TimingTree.scope`), or a
    context that does nothing where there is none."""
    tree = _ACTIVE.tree
    if tree is None:
        return _NO_SCOPE
    return tree.scope(label, device, b)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the thread's active tree, if any."""
    tree = _ACTIVE.tree
    if tree is not None:
        tree.count(name, n)


def totals() -> dict:
    """{name: n} summed over every enabled tree of the process."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


class TimingTree:
    def __init__(self, name: str = "root", enabled: bool | None = None):
        echo = bool(os.environ.get("PLONKY2_TPU_TIMING"))
        self.name = name
        self.enabled = (echo or bool(os.environ.get("PLONKY2_TPU_PROFILE"))
                        if enabled is None else enabled)
        self.echo = echo
        self.records: list[tuple[int, str, float]] = []
        self.spans: list[Span] = []
        self.counts: dict = {}
        self.span_counts: dict = {}
        self._open: list[tuple[int, str, int | None]] = []   # (id, label, b)
        self._ids = itertools.count()
        if self.enabled:
            _maybe_start_profiler()

    @contextmanager
    def scope(self, label: str, device=None, b: int | None = None):
        """Time the block as `label`; `b`: the proof of a batch it belongs
        to, by default that of the scope it opens inside."""
        if not self.enabled:
            yield
            return
        parent = self._open[-1] if self._open else None
        if b is None and parent is not None:
            b = parent[2]
        sid = next(self._ids)
        self._open.append((sid, label, b))
        outer, _ACTIVE.tree = _ACTIVE.tree, self
        t0 = time.perf_counter()
        start = end = time.time_ns()
        try:
            with torch.profiler.record_function(label):
                try:
                    yield
                    if (device is not None
                            and torch.device(device).type == "cuda"):
                        torch.cuda.synchronize(device)
                finally:
                    end = time.time_ns()    # before the range's own end
        finally:
            dt = time.perf_counter() - t0
            _ACTIVE.tree = outer
            self._open.pop()
            depth = len(self._open)
            self.records.append((depth, label, dt))
            self.spans.append(Span(sid, None if parent is None else parent[0],
                                   label, start, end, b))
            if self.echo:
                print(f"[timing] {'  ' * depth}{dt * 1e3:9.1f} ms  "
                      f"{label}", flush=True)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name`, in total and under the innermost
        open scope; nothing on a disabled tree."""
        if not self.enabled:
            return
        self.counts[name] = self.counts.get(name, 0) + n
        if self._open:
            by = self.span_counts.setdefault(self._open[-1][1], {})
            by[name] = by.get(name, 0) + n
        with _TOTALS_LOCK:
            _TOTALS[name] = _TOTALS.get(name, 0) + n

    def print(self) -> str:
        """Print and return the closed scopes as a tree, each with its
        milliseconds, outer scopes before the scopes inside them
        (reference: timing.rs TimingTree::print)."""
        pending = []
        for depth, label, dt in self.records:   # inner scopes close first
            inner = [p for p in pending if p[0] > depth]
            pending = [p for p in pending if p[0] <= depth]
            pending.append((depth, [f"{'  ' * depth}{dt * 1e3:9.1f} ms  "
                                    f"{label}"] + [line for p in inner
                                                   for line in p[1]]))
        lines = [line for p in pending for line in p[1]]
        text = "\n".join([self.name] + lines)
        print(text, flush=True)
        return text

    def seconds(self) -> dict:
        """{label: total seconds} over every closed scope."""
        out: dict = {}
        for _, label, dt in self.records:
            out[label] = out.get(label, 0.0) + dt
        return out


_NULL = TimingTree(enabled=False)


def null_timing() -> TimingTree:
    return _NULL
