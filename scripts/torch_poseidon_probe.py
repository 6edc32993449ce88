#!/usr/bin/env python3
"""Probe the port's Poseidon kernels (K2 `poseidon_permute`, K3
`poseidon_hash_leaves`, and `poseidon_merkle_tree` where the library has it)
on one NVIDIA GPU:

    python3 scripts/torch_poseidon_probe.py [--out DIR]
        [--variants MACRO=VALUE[,MACRO=VALUE...] ...]

Prints, for the kernel library built from plonky2_tpu_torch/csrc:
  - ptxas registers and spills of every kernel (`-Xptxas -v`);
  - the SASS of every kernel function by opcode (`cuobjdump -sass`): the
    static instruction count, by opcode and by class;
  - K2 at 2^19, 2^15, 2^10, 256 and 16 states and K3 at [135|84|20|16, 2^17]:
    device time per launch from torch.profiler (the kernels' own spans),
    device time from CUDA events with the queue filled ahead by a sleep
    kernel, and the wrapper's time from CUDA events around back-to-back
    calls (which is the host's time whenever that is the longer);
  - every output bit-checked against the plain PyTorch version.
With --variants it first builds csrc/poseidon.cu alone once for each
given set of macro definitions (forms of the source selected with `#if`),
and times each against the others in turns (K2 at 2^19 and 16 states, K3
at [135, 2^17]), every output bit-checked.
The SASS listing of the Poseidon kernels goes to DIR (default
chiprun_out/probe). Imports nothing of JAX or of the JAX package; exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import ctypes

sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLASSES = (  # opcode prefix -> class, first match wins
    ("IMAD.WIDE", "imad.wide"), ("IMAD.HI", "imad.hi"),
    ("IMAD.MOV", "move"), ("IMAD.SHL", "shift"), ("IMAD.IADD", "add"),
    ("IMAD.X", "add"), ("IMAD", "imad"), ("IMUL", "imad"),
    ("IADD3", "add"), ("IADD", "add"), ("LEA", "add"),
    ("ISETP", "compare"), ("SEL", "select"), ("SHF", "shift"),
    ("SHL", "shift"), ("LOP3", "logic"), ("MOV", "move"),
    ("LDC", "const load"), ("ULDC", "const load"), ("LDG", "global load"),
    ("STG", "global store"), ("LDS", "shared"), ("STS", "shared"),
    ("BRA", "branch"), ("BAR", "barrier"), ("U", "uniform"),
)


def opclass(op: str) -> str:
    for prefix, cls in CLASSES:
        if op.startswith(prefix):
            return cls
    return "other"


def sass_histograms(lib_path: str, out_dir: str) -> dict:
    """{function: Counter(opcode)} from cuobjdump -sass of the library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    keep, fn = [], None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line
        if fn is not None and "poseidon_cu" in fn:
            keep.append(line)
    with open(os.path.join(out_dir, os.path.basename(lib_path) + ".sass"),
              "w") as f:
        f.write("\n".join(keep))
    hists, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            hists[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and fn is not None:
            hists[fn][m.group(1)] += 1
    return hists


def device_ms_profiler(fn, reps: int, match: str) -> tuple:
    """(ms per call of the device spans whose name contains `match`,
    launches seen per call) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in p.key_averages():
        if match in e.key:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            total_us += t
            count += e.count
    return total_us / reps / 1e3, count / reps


def device_ms_events(fn, reps: int) -> float:
    """ms per call from CUDA events, with the queue filled ahead by a sleep
    kernel so that the launches run back to back on the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)          # ~25 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wrapper_ms(fn, reps: int) -> float:
    """ms per call of back-to-back wrapper calls, CUDA events (the chip
    smoke's `_time_ms`)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_variants(variants, out_dir: str) -> dict:
    """{variant: ctypes library} of csrc/poseidon.cu alone, built with each
    variant's macros ((name, value) pairs), one nvcc per variant, all
    started together."""
    from plonky2_tpu_torch import backend
    tmp = tempfile.mkdtemp()
    for name, text in backend._tables().items():
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    src = os.path.join(backend.CSRC_DIR, "poseidon.cu")
    jobs = {}
    for variant in variants:
        tag = "_".join(f"{k}{v}" for k, v in variant)
        lib = os.path.join(tmp, f"libposeidon_{tag}.so")
        cmd = [backend.nvcc_path(), *backend.NVCC_FLAGS, "-shared",
               "-Xptxas", "-v", *(f"-D{k}={v}" for k, v in variant),
               "-I", tmp, "-I", backend.CSRC_DIR, "-o", lib, src]
        jobs[variant] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for key, (path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        print(f"variant {dict(key)}:")
        for line in err.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                print("  " + line.strip())
        for fn, hist in sass_histograms(path, out_dir).items():
            print(f"  SASS {fn}: {sum(hist.values())} instructions")
        lib = ctypes.CDLL(path)
        lib.poseidon_permute.argtypes = [p, p, ll, p]
        lib.poseidon_hash_leaves.argtypes = [p, p, i, ll, p]
        libs[key] = lib
    return libs


def compare_variants(libs: dict, device) -> None:
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash import poseidon as ps
    rng = np.random.default_rng(5)
    rand = lambda *s: gl.from_u64(rng.integers(0, gl.ORDER, size=s,
                                               dtype=np.uint64), device)
    states = {b: rand(b, 12) for b in (1 << 19, 16)}
    leaves = {n: rand(135, n) for n in (1 << 17, 1 << 12)}
    want = {b: ps.permute_plain(s) for b, s in states.items()}
    want_leaves = ps.hash_leaves_plain(leaves[1 << 12])
    stream = lambda: torch.cuda.current_stream(device).cuda_stream

    def perm(lib, s):
        out = torch.empty_like(s)
        assert lib.poseidon_permute(s.data_ptr(), out.data_ptr(),
                                    s.shape[0], stream()) == 0
        return out

    def leaf(lib, x):
        out = torch.empty((x.shape[1], 4), dtype=torch.int64, device=device)
        assert lib.poseidon_hash_leaves(x.data_ptr(), out.data_ptr(),
                                        x.shape[0], x.shape[1],
                                        stream()) == 0
        return out

    for key, lib in libs.items():
        for b, s in states.items():
            assert torch.equal(perm(lib, s), want[b]), (key, b)
        assert torch.equal(leaf(lib, leaves[1 << 12]), want_leaves), key
    times = collections.defaultdict(list)
    for key in list(libs) + list(reversed(list(libs))):
        lib = libs[key]
        times[key, "permute 2^19"].append(device_ms_events(
            lambda: perm(lib, states[1 << 19]), 20))
        times[key, "permute 16"].append(device_ms_events(
            lambda: perm(lib, states[16]), 200))
        times[key, "leaves 135x2^17"].append(device_ms_events(
            lambda: leaf(lib, leaves[1 << 17]), 10))
    for (key, what), ts in sorted(times.items()):
        print(f"variant {dict(key)} {what}: device ms "
              + ", ".join(f"{t:.5f}" for t in ts))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "probe"))
    ap.add_argument("--variants", nargs="*", default=[],
                    metavar="MACRO=VALUE[,MACRO=VALUE...]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_poseidon_probe.py: no CUDA device", file=sys.stderr)
        return 1
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash import poseidon as ps

    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.variants:
        variants = [tuple(tuple(d.split("=", 1)) for d in v.split(","))
                    for v in args.variants]
        compare_variants(build_variants(variants, args.out), device)
    print(f"build {backend.build():.3f} s", flush=True)
    for line in backend.PTXAS_REPORT.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    lib_path = max(glob.glob(os.path.join(backend.BUILD_DIR,
                                          "libplonky2_kernels-*.so")),
                   key=os.path.getmtime)
    for fn, hist in sass_histograms(lib_path, args.out).items():
        if "oseidon" not in fn and "permute" not in fn and "leaves" not in \
                fn and "merkle" not in fn:
            continue
        classes = collections.Counter()
        for op, n in hist.items():
            classes[opclass(op)] += n
        print(f"SASS {fn}: {sum(hist.values())} instructions")
        print("  by class: " + json.dumps(dict(classes.most_common())))
        print("  by opcode: " + json.dumps(dict(hist.most_common(40))))

    rng = np.random.default_rng(11)
    rand = lambda *s: gl.from_u64(rng.integers(0, gl.ORDER, size=s,
                                               dtype=np.uint64), device)
    rows = []
    for b in (1 << 19, 1 << 15, 1 << 10, 256, 16):
        s = rand(b, 12)
        run = lambda: ps.permute(s)
        assert torch.equal(run(), ps.permute_plain(s)), b
        reps = 20 if b >= 1 << 15 else 200
        prof, per = device_ms_profiler(run, reps, "permute")
        rows.append(("poseidon_permute", [b], prof, per,
                     device_ms_events(run, reps), wrapper_ms(run, reps)))
    for L in (135, 84, 20, 16):
        x = rand(L, 1 << 17)
        run = lambda: ps.hash_leaves(x)
        assert torch.equal(run(), ps.hash_leaves_plain(x)), L
        prof, per = device_ms_profiler(run, 10, "leaves")
        rows.append(("poseidon_hash_leaves", [L, 1 << 17], prof, per,
                     device_ms_events(run, 10), wrapper_ms(run, 10)))
    edge = np.array([0, 1, gl.ORDER - 1, 2**32 - 1, 2**32, gl.ORDER,
                     2**64 - 1], dtype=np.uint64)
    e = rng.integers(0, 2**64, size=(4096, 12), dtype=np.uint64)
    e[:2048] = edge[rng.integers(0, len(edge), size=(2048, 12))]
    e = torch.from_numpy(e.view(np.int64)).to(device)
    assert torch.equal(ps.permute(e), ps.permute_plain(e)), "edge batch"
    print("edge batch: permute bit-exact")
    if hasattr(ps, "merkle_layers"):
        for lg_n, cap in ((20, 4), (17, 0), (11, 3), (10, 10), (8, 2), (1, 0)):
            d = rand(1 << lg_n, 4)
            got, want = ps.merkle_layers(d, cap), ps.merkle_layers_plain(d, cap)
            assert len(got) == len(want) == lg_n - cap and all(
                torch.equal(a, b) for a, b in zip(got, want)), (lg_n, cap)
        print("merkle tree bit-exact at (20,4) (17,0) (11,3) (10,10) (8,2) "
              "(1,0)")
        for lg_n in (17, 13, 9, 5):
            d = rand(1 << lg_n, 4)
            got = torch.cat(ps.merkle_layers(d, 4))
            assert torch.equal(got, torch.cat(ps.merkle_layers_plain(d, 4))
                               ), lg_n
            run = lambda: ps.merkle_layers(d, 4)
            prof, per = device_ms_profiler(run, 50, "merkle")
            rows.append(("poseidon_merkle_tree", [1 << lg_n, 4], prof, per,
                         device_ms_events(run, 50), wrapper_ms(run, 50)))
    for name, shape, prof, per, ev, wrap in rows:
        print(f"{name} {shape}: profiler device {prof:.5f} ms "
              f"({per:g} launches/call), events device {ev:.5f} ms, "
              f"wrapper {wrap:.5f} ms")
    print(json.dumps({"probe": [dict(name=n, shape=s, profiler_ms=p,
                                     launches_per_call=c, device_ms=e,
                                     wrapper_ms=w)
                                for n, s, p, c, e, w in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
