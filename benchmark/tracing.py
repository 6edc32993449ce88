"""What a traced run reads: the prover's scopes, a profiler capture of one
call kept in memory, and the hand kernels' launches in that call.

`Capture` profiles one call (host and card, no Chrome trace is written:
the events are read in memory) while `LaunchLog` records each hand-kernel
call with the shape the program's kernel records give it. `TraceData`
holds what the per-layer readers under `metrics/` take from them.
"""

from __future__ import annotations

import dataclasses
import re

# events on the card's timeline that are no operation of the card's
_NOT_DEVICE_OPS = re.compile(r"annotation", re.I)


@dataclasses.dataclass
class TraceData:
    proofs: int                  # proofs of the captured call
    window_ns: tuple[int, int]   # the captured call, on the profiler's clock
    kernels: list                # (name, start_ns, duration_ns) of kernels
    device_ops: list             # kernels, copies and sets alike
    scopes: list                 # (label, start_ns, end_ns) of host scopes
    kernel_calls: dict           # kernel record -> [shape of each call]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, inside the
        window."""
        lo, hi = self.window_ns
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d in self.device_ops if s < hi and s + d > lo)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_gaps(self) -> list[tuple[int, int]]:
        lo, hi = self.window_ns
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def open_scope(self, t: int) -> str:
        """The innermost host scope open at t."""
        best = None
        for label, s, e in self.scopes:
            if s <= t < e and (best is None or s >= best[1]):
                best = (label, s)
        return best[0] if best else "outside the prover's scopes"

    def breakdown(self) -> dict:
        by_op: dict = {}
        for name, _, d in self.device_ops:
            by_op[name] = by_op.get(name, 0) + d
        by_scope: dict = {}
        for s, e in self.idle_gaps():
            label = self.open_scope((s + e) // 2)
            by_scope[label] = by_scope.get(label, 0) + (e - s)
        top = lambda d: [[name[:200], ns * 1e-9] for name, ns in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_scope)}


class LaunchLog:
    """Records, while open, each call into the kernel library and the
    kernel records it raised: a call's launches share its shape."""

    def __init__(self):
        self.calls: dict = {}

    def __enter__(self):
        from plonky2_tpu_torch import backend
        self._backend = backend
        self._call = backend.call
        self._serial = 0
        seen = set()

        def call(entry, t, *args):
            self._serial += 1
            return self._call(entry, t, *args)

        def hook(kernel):
            launched = kernel.launched

            def record(shape):
                key = (self._serial, kernel.name)
                if key not in seen:
                    seen.add(key)
                    self.calls.setdefault(kernel.name, []).append(shape)
                launched(shape)
            return record

        backend.call = call
        for kernel in backend.KERNELS.values():
            kernel.launched = hook(kernel)
        return self

    def __exit__(self, *exc):
        self._backend.call = self._call
        for kernel in self._backend.KERNELS.values():
            del kernel.launched
        return False


class Capture:
    """torch.profiler over one call, host and card; `data(proofs)` after
    it closes."""

    LABEL = "benchmark.captured_call"

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._cuda = torch.cuda.is_available()
        if self._cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + [ProfilerActivity.CUDA] * self._cuda)
        self._prof.__enter__()
        self._range = record_function(self.LABEL)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        if self._cuda:
            torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def data(self, proofs: int, kernel_calls: dict,
             labels: set) -> TraceData:
        """What the capture holds. `labels` are the captured call's scope
        labels: the profiler shows each scope as a host range and again as
        a range on the card, which is no operation of the card's."""
        from torch.autograd import DeviceType
        labels = set(labels) | {self.LABEL}
        window = None
        kernels, device_ops, scopes = [], [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = _start_ns(e), _duration_ns(e)
            if e.device_type() == DeviceType.CUDA:
                if name in labels or _NOT_DEVICE_OPS.search(_kind(e)):
                    continue
                device_ops.append((name, start, dur))
                if not name.startswith(("Memcpy", "Memset")):
                    kernels.append((name, start, dur))
            elif name == self.LABEL:
                window = (start, start + dur)
            elif name in labels:
                scopes.append((name, start, start + dur))
        if window is None:
            raise RuntimeError("the capture holds no window range")
        return TraceData(proofs=proofs, window_ns=window, kernels=kernels,
                         device_ops=device_ops, scopes=scopes,
                         kernel_calls=kernel_calls)


# the profiler's event records differ between PyTorch versions
def _kind(e) -> str:
    kind = getattr(e, "activity_type", None)
    return kind() if kind else ""


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()


def _duration_ns(e) -> int:
    return (e.duration_ns() if hasattr(e, "duration_ns")
            else 1000 * e.duration_us())
