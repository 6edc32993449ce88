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

Profiler capture: with PLONKY2_TPU_PROFILE=<dir> set, the first enabled tree
starts a `torch.profiler.profile` of the host and, where there is a card, of
the card; `stop_profiler()` stops it and writes its Chrome trace (.json)
under <dir>, in which every scope is a named range on both timelines.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

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


class TimingTree:
    def __init__(self, name: str = "root", enabled: bool | None = None):
        echo = bool(os.environ.get("PLONKY2_TPU_TIMING"))
        self.name = name
        self.enabled = (echo or bool(os.environ.get("PLONKY2_TPU_PROFILE"))
                        if enabled is None else enabled)
        self.echo = echo
        self.records: list[tuple[int, str, float]] = []
        self._depth = 0
        if self.enabled:
            _maybe_start_profiler()

    @contextmanager
    def scope(self, label: str, device=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        self._depth += 1
        try:
            with torch.profiler.record_function(label):
                yield
                if device is not None and torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
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
