"""TimingTree — hierarchical scoped timer (reference: util/timing.rs
TimingTree:8, the timed! macro :179).

Each scope is a `torch.profiler.record_function` range, so a profiler run
shows the prover's phases on the card's timeline, and its host seconds are
kept in `records` as (depth, label, seconds) in the order the scopes close.
`sync`, when given (e.g. `torch.cuda.synchronize`), is called at the end of
every scope, so its seconds include the device work queued inside it.
Enabled when constructed with enabled=True or when PLONKY2_TPU_TIMING is
set; the latter also prints each scope as it closes.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


class TimingTree:
    def __init__(self, name: str = "root", enabled: bool | None = None,
                 sync=None):
        echo = bool(os.environ.get("PLONKY2_TPU_TIMING"))
        self.name = name
        self.enabled = echo if enabled is None else enabled
        self.echo = echo
        self.sync = sync
        self.records: list[tuple[int, str, float]] = []
        self._depth = 0

    @contextmanager
    def scope(self, label: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        self._depth += 1
        try:
            with torch.profiler.record_function(label):
                yield
                if self.sync is not None:
                    self.sync()
        finally:
            self._depth -= 1
            dt = time.perf_counter() - t0
            self.records.append((self._depth, label, dt))
            if self.echo:
                print(f"[timing] {'  ' * self._depth}{dt * 1e3:9.1f} ms  "
                      f"{label}", flush=True)

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
