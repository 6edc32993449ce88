#!/usr/bin/env python3
"""The benchmark of plonky2_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (`cells/<cell>.json`) names a configuration (`configs/<name>.json`,
driven through the program by `configs/<name>.py` and checked by
`reference/<name>.py`) and a traffic mix (`traffic/<name>.json`). A run
builds the cell's circuit or table, proves one cold and one warm call at
the cell's shapes, then proves calls back to back, one caller in a closed
loop, until `--seconds` have passed (a call started inside the window runs
to its end). With `--trace 1` every call of the window runs under an
enabled TimingTree and one more call runs under the profiler. Then the
program's state is freed and the reference checks the proofs: every
proof's public inputs, and a sample of calls drawn from the seed in full.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer ones with --trace 1, each read by `metrics/<name>.py`), device,
with --trace 1 breakdown, and last the numbers compared with their limits.
"""

from __future__ import annotations

import argparse
import gc
import importlib.abc
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# what the process may never load, compared by top-level module name
BLOCKED = ("jax", "jaxlib", "flax", "plonky2_tpu")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name}: the benchmark runs without JAX and "
                              "without the JAX package")
        return None


def loaded_blocked() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)


def process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


class Requests:
    """The cell's requests, drawn from the seed: call i of the window gets
    the next `proofs_per_call` draws of its own stream, whatever the
    timing, and the warm-up calls draw from another."""

    def __init__(self, seed: int, cfg: dict, traffic: dict, draw):
        import numpy as np
        children = np.random.SeedSequence(abs(int(seed))).spawn(3)
        self._warm = np.random.default_rng(children[0])
        self._window = np.random.default_rng(children[1])
        self.sampler = np.random.default_rng(children[2])
        self.cfg, self.draw = cfg, draw
        self.per_call = int(traffic["proofs_per_call"])

    def warm_call(self) -> list:
        return [self.draw(self._warm, self.cfg) for _ in range(self.per_call)]

    def next_call(self) -> list:
        return [self.draw(self._window, self.cfg)
                for _ in range(self.per_call)]


class Context:
    """What the metric readers see."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Prefetch:
    """The window's calls as (inputs, prepared inputs), each prepared on the
    pool's thread while the call before it proves; the first is prepared
    before the window opens."""

    def __init__(self, system, requests: Requests, pool: ThreadPoolExecutor):
        def prep():
            inputs = requests.next_call()
            return inputs, system.prepare(inputs)
        self._prep, self._pool = prep, pool
        self._future = pool.submit(prep)

    def wait(self) -> None:
        self._future.result()

    def next(self):
        item = self._future.result()
        self._future = self._pool.submit(self._prep)
        return item


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _apply(cfg: dict, patch: dict | None) -> dict:
    out = json.loads(json.dumps(cfg))
    for key, value in (patch or {}).items():
        if isinstance(value, dict):
            out[key] = _apply(out.get(key, {}), value)
        else:
            out[key] = value
    return out


def metric_specs(workload: str, trace: bool) -> list[dict]:
    from benchmark import load
    spec = load.benchmark_json()
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", started: float | None = None,
             config_patch: dict | None = None,
             program_patch: dict | None = None, fault=None) -> tuple:
    """One run. `config_patch` changes the configuration both sides get
    (the tests' small sizes); `program_patch` changes the one the program
    gets (the control), and the reference keeps the configuration's own;
    `fault` wraps the system's prove, for the tests that break the timed
    path. Returns the result object and the lines for standard error: the
    reasons of any refusal, the seconds of each phase, the calls checked."""
    import torch

    from benchmark import load
    from plonky2_tpu_torch.utils.timing import TimingTree

    started = time.time() if started is None else started
    cuda = torch.device(device).type == "cuda"
    cell = load.data("cells", workload)
    cfg = _apply(load.data("configs", cell["config"]), config_patch)
    traffic = load.data("traffic", cell["traffic"])
    driver = load.module("configs", cell["config"])
    reference = load.module("reference", cell["config"])
    specs = metric_specs(workload, trace)

    # set-up: the circuit or table, then a cold and a warm call
    system = driver.System(_apply(cfg, program_patch), device, seed)
    prove = system.prove if fault is None else fault(system.prove)
    requests = Requests(seed, cfg, traffic, driver.draw)
    for _ in range(2):
        prove(system.prepare(requests.warm_call()),
              TimingTree(enabled=False))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    calls, attempted, failed = [], 0, 0
    with ThreadPoolExecutor(max_workers=1) as pool:
        stream = Prefetch(system, requests, pool)
        stream.wait()
        t0 = time.perf_counter()
        setup_s = time.time() - started
        while time.perf_counter() - t0 < seconds:
            inputs, prepared = stream.next()
            tree = TimingTree(enabled=trace)
            attempted += len(inputs)
            t_call = time.perf_counter()
            try:
                proofs = prove(prepared, tree)
            except Exception:       # a failed call counts; the loop goes on
                traceback.print_exc()
                failed += len(inputs)
                proofs = []
            calls.append({"inputs": inputs, "proofs": proofs,
                          "scopes": tree.seconds(),
                          "seconds": time.perf_counter() - t_call})
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0

        t_trace = time.perf_counter()
        trace_data = None
        if trace:
            from benchmark.tracing import Capture, LaunchLog
            inputs, prepared = stream.next()
            attempted += len(inputs)
            tree = TimingTree(enabled=True)
            with LaunchLog() as log, Capture() as capture:
                proofs = prove(prepared, tree)
            trace_data = capture.data(len(proofs), log.calls,
                                      {label for _, label, _ in tree.records})
            calls.append({"inputs": inputs, "proofs": proofs, "scopes": {},
                          "seconds": None})
            del capture

    window_calls = calls[:-1] if trace else calls
    ctx = Context(seconds=seconds, window_s=window_s, setup_s=setup_s,
                  proofs=sum(len(c["proofs"]) for c in window_calls),
                  peak_bytes=peak, proofs_per_call=requests.per_call,
                  scopes=[c["scopes"] for c in window_calls],
                  trace=trace_data)
    values = {}
    for spec in specs:
        value = load.module("metrics", spec["name"]).read(ctx)
        if value is not None:
            values[spec["name"]] = {"value": value, "unit": spec["unit"]}

    # the check, once the program's state is freed
    plain_calls = [{"inputs": c["inputs"],
                    "proofs": [system.plain(p) for p in c["proofs"]]}
                   for c in calls]
    del calls, prove
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    count = min(int(cell["check_calls"]), len(plain_calls))
    sample = sorted(int(i) for i in requests.sampler.choice(
        len(plain_calls), size=count, replace=False)) if count else []
    t_check = time.perf_counter()
    numbers, reasons = reference.check(cfg, plain_calls, sample, device)
    reasons.append("seconds of the window's calls: " + ", ".join(
        f"{c['seconds']:.3f}" for c in window_calls))
    reasons.append(f"seconds: set-up {setup_s:.2f}, window {window_s:.2f}, "
                   f"traced call {t_check - t_trace:.2f} (with the "
                   f"program's release), check "
                   f"{time.perf_counter() - t_check:.2f}")
    correct = (attempted > 0 and failed == 0 and bool(sample)
               and all(v <= limit for v, limit in numbers.values()))

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values,
              "device": {"platform": "gpu" if cuda else device,
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else device),
                         "count": 1, "memory_peak_bytes": peak}}
    if cuda:
        result["device"]["power_limit_w"] = _power_limit_w()
    if trace_data is not None:
        result["device"]["busy_s"] = trace_data.busy_s()
        result["device"]["window_s"] = trace_data.window_s
        result["breakdown"] = trace_data.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in numbers.items()}
    reasons.append(f"calls checked in full: {sample} of {len(plain_calls)}")
    return result, reasons


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = process_start()
    sys.meta_path.insert(0, _Blocker())
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ[var] = os.path.join(CACHE_DIR, var.lower())
    if loaded_blocked():
        print(f"loaded before the run: {loaded_blocked()}", file=sys.stderr)
        return 4

    import torch

    from benchmark import load
    chips = int(load.data("cells", args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, reasons = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), started=started)
    leaked = loaded_blocked()
    if leaked:
        print(f"loaded during the run: {leaked}", file=sys.stderr)
        return 4
    for line in reasons:
        print(line, file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
