#!/usr/bin/env python3
"""Probe the port's Poseidon or Poseidon2 kernels on one NVIDIA GPU:

    python3 scripts/torch_poseidon_probe.py [--hasher poseidon|poseidon2]
        [--out DIR] [--variants MACRO=VALUE[,MACRO=VALUE...] ...]

The kernels of a hasher: its permutation (K2 `poseidon_permute`, K6
`poseidon2_permute`), its leaf sponge (K3 `poseidon_hash_leaves`, K7
`poseidon2_hash_leaves`) and, where the library has it, its Merkle tree
entry (`*_merkle_tree`; without it the hasher's `merkle_layers` is timed as
it is). Prints, for the kernel library built from plonky2_tpu_torch/csrc:
  - ptxas registers and spills of every kernel (`-Xptxas -v`);
  - the SASS of the hasher's kernel functions by opcode (`cuobjdump -sass`):
    the static instruction count, by opcode and by class;
  - the permutation at 2^19, 2^15, 2^10, 256 and 16 states, the leaf sponge
    at [135|84|20|16, 2^17] and at the FRI leaves [32, 2^13|2^9|2^5], and
    the tree of 2^17, 2^13, 2^9 and 2^5 leaves at cap height 4: device time
    per call from torch.profiler (the kernels' own spans), device time from
    CUDA events with the queue filled ahead by a sleep kernel, and the
    wrapper's time from CUDA events around back-to-back calls (which is the
    host's time whenever that is the longer);
  - every output bit-checked against the plain PyTorch version, and an
    edge batch (0, 1, p - 1, 2^32 - 1, 2^32 and the non-canonical p, p + 1,
    2^64 - 1, with a state of all 2^64 - 1) through the permutation: a
    difference there is reported, and the script then exits 1 after its
    last line.
With --variants it first builds the hasher's source alone once for each
given set of macro definitions (forms of the source selected with `#if`),
and times each against the others in turns (the permutation at 2^19 and 16
states, the leaf sponge at [135, 2^17] and at the FRI leaves [32,
2^13|2^9|2^5], the tree at 2^17 leaves where the library has it), every output bit-checked.
The SASS listing of the hasher's kernels goes to DIR (default
chiprun_out/probe). Imports nothing of JAX or of the JAX package; exits
non-zero without a GPU.

    python3 scripts/torch_poseidon_probe.py --kernel ntt [--variants ...]

probes K1 (csrc/ntt.cu) instead, through the functions of
plonky2_tpu_torch/ops/ntt.py that the prover calls, at its shapes:
coset_lde of [135|20|16, 2^14] at rate 3, ifft of [135|20, 2^14],
coset_ifft of [2, 2^17], coset_fft of [1, 2^13|2^9|2^5], coset_fft_ext
at 2^13 and the FRI opening LDE of an extension row of 2^14 at rate 3.
For each: its output against the plain composition (shift multiply,
bit-reversal, repeat, `dit_plain`, index reversal, scale) on the card, its
CUDA launches a call and their names (torch.profiler), device ms (CUDA
events behind a sleep kernel) and wrapper ms; then ptxas registers and
spills and the SASS of ntt.cu's kernels by class. The same functions exist
in earlier forms of ops/ntt.py, so the probe times those too. With
--variants it builds ntt.cu alone for each macro set and times its
entries in turns (the LDE [135|20|2, 2^14 -> 2^17], the iNTT [135|20,
2^14], the coset iNTT [2, 2^17], the fold [2, 2^13|2^9]), every output
bit-checked.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import glob
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile

sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# hasher -> (module, source, C entry prefix)
HASHERS = {"poseidon": ("plonky2_tpu_torch.hash.poseidon", "poseidon.cu",
                        "poseidon"),
           "poseidon2": ("plonky2_tpu_torch.hash.poseidon2", "poseidon2.cu",
                         "poseidon2")}

CLASSES = (  # opcode prefix -> class, first match wins
    ("IMAD.WIDE", "imad.wide"), ("IMAD.HI", "imad.hi"),
    ("IMAD.MOV", "move"), ("IMAD.SHL", "shift"), ("IMAD.IADD", "add"),
    ("IMAD.X", "add"), ("IMAD", "imad"), ("IMUL", "imad"),
    ("IADD3", "add"), ("IADD", "add"), ("LEA", "add"),
    ("ISETP", "compare"), ("SEL", "select"), ("SHF", "shift"),
    ("SHL", "shift"), ("LOP3", "logic"), ("MOV", "move"),
    ("LDC", "const load"), ("ULDC", "const load"), ("LDG", "global load"),
    ("STG", "global store"), ("LDS", "shared"), ("STS", "shared"),
    ("SHFL", "shuffle"), ("BRA", "branch"), ("BAR", "barrier"),
    ("U", "uniform"),
)


def opclass(op: str) -> str:
    for prefix, cls in CLASSES:
        if op.startswith(prefix):
            return cls
    return "other"


def sass_histograms(lib_path: str, out_dir: str, source: str) -> dict:
    """{function: Counter(opcode)} of the functions compiled from `source`
    (cuobjdump -sass of the library); their listing goes to out_dir."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    tag = "_" + source.replace(".", "_") + "_"
    hists, fn, keep = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if tag in m.group(1) else None
            if fn is not None:
                hists[fn] = collections.Counter()
        if fn is None:
            continue
        keep.append(line)
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            hists[fn][m.group(1)] += 1
    with open(os.path.join(out_dir, os.path.basename(lib_path) + ".sass"),
              "w") as f:
        f.write("\n".join(keep))
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
    """ms per call of back-to-back wrapper calls, CUDA events."""
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


def build_variants(variants, out_dir: str, source: str, prefix: str) -> dict:
    """{variant: ctypes library} of csrc/`source` alone, built with each
    variant's macros ((name, value) pairs), one nvcc per variant, all
    started together; prints each one's ptxas lines and SASS sizes."""
    from plonky2_tpu_torch import backend
    tmp = tempfile.mkdtemp()
    for name, text in backend._tables().items():
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    src = os.path.join(backend.CSRC_DIR, source)
    jobs = {}
    for variant in variants:
        tag = "_".join(f"{k}{v}" for k, v in variant)
        lib = os.path.join(tmp, f"lib{prefix}_{tag}.so")
        cmd = [backend.nvcc_path(), *backend.NVCC_FLAGS, "-shared",
               "-Xptxas", "-v", *(f"-D{k}={v}" for k, v in variant),
               "-I", tmp, "-I", backend.CSRC_DIR, "-o", lib, src]
        jobs[variant] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        print(f"variant {dict(key)}:")
        for line in err.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                print("  " + line.strip())
        for fn, hist in sass_histograms(path, out_dir, source).items():
            print(f"  SASS {fn}: {sum(hist.values())} instructions")
        libs[key] = ctypes.CDLL(path)
    return libs


def hasher_variants(variants, out_dir: str, source: str, prefix: str) -> dict:
    """`build_variants` of a hasher's source, its entries bound."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build_variants(variants, out_dir, source, prefix)
    for lib in libs.values():
        getattr(lib, f"{prefix}_permute").argtypes = [p, p, ll, p]
        getattr(lib, f"{prefix}_hash_leaves").argtypes = [p, p, i, ll, p]
        if hasattr(lib, f"{prefix}_merkle_tree"):
            getattr(lib, f"{prefix}_merkle_tree").argtypes = [
                p, p, ll, i, p, ctypes.POINTER(ctypes.c_int)]
    return libs


def compare_variants(libs: dict, device, mod, prefix: str) -> None:
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash import sponge
    rng = np.random.default_rng(5)
    rand = lambda *s: gl.from_u64(rng.integers(0, gl.ORDER, size=s,
                                               dtype=np.uint64), device)
    states = {b: rand(b, 12) for b in (1 << 19, 16)}
    narrow = [(32, 1 << 13), (32, 1 << 9), (32, 1 << 5)]
    leaves = {s: rand(*s) for s in [(135, 1 << 17), (135, 1 << 12)] + narrow}
    digests = rand(1 << 17, 4)
    want = {b: mod.permute_plain(s) for b, s in states.items()}
    want_leaves = {s: mod.hash_leaves_plain(leaves[s])
                   for s in [(135, 1 << 12)] + narrow}
    want_tree = torch.cat(sponge.merkle_layers_by_level(
        digests, 4, lambda a, b: sponge.compress(a, b, mod.permute_plain)))
    stream = lambda: torch.cuda.current_stream(device).cuda_stream

    def perm(lib, s):
        out = torch.empty_like(s)
        assert getattr(lib, f"{prefix}_permute")(
            s.data_ptr(), out.data_ptr(), s.shape[0], stream()) == 0
        return out

    def leaf(lib, x):
        out = torch.empty((x.shape[1], 4), dtype=torch.int64, device=device)
        assert getattr(lib, f"{prefix}_hash_leaves")(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            stream()) == 0
        return out

    def tree(lib, d):
        out = torch.empty((d.shape[0] - 16, 4), dtype=torch.int64,
                          device=device)
        launches = ctypes.c_int(0)
        assert getattr(lib, f"{prefix}_merkle_tree")(
            d.data_ptr(), out.data_ptr(), d.shape[0], 4, stream(),
            ctypes.byref(launches)) == 0
        return out

    has_tree = all(hasattr(lib, f"{prefix}_merkle_tree")
                   for lib in libs.values())
    for key, lib in libs.items():
        for b, s in states.items():
            assert torch.equal(perm(lib, s), want[b]), (key, b)
        for s, w in want_leaves.items():
            assert torch.equal(leaf(lib, leaves[s]), w), (key, s)
        if has_tree:
            assert torch.equal(tree(lib, digests), want_tree), key
    times = collections.defaultdict(list)
    for key in list(libs) + list(reversed(list(libs))):
        lib = libs[key]
        times[key, "permute 2^19"].append(device_ms_events(
            lambda: perm(lib, states[1 << 19]), 20))
        times[key, "permute 16"].append(device_ms_events(
            lambda: perm(lib, states[16]), 200))
        times[key, "leaves 135x2^17"].append(device_ms_events(
            lambda: leaf(lib, leaves[135, 1 << 17]), 10))
        for L, n in narrow:
            times[key, f"leaves {L}x2^{n.bit_length() - 1}"].append(
                device_ms_events(lambda: leaf(lib, leaves[L, n]), 100))
        if has_tree:
            times[key, "tree 2^17"].append(device_ms_events(
                lambda: tree(lib, digests), 50))
    for (key, what), ts in sorted(times.items()):
        print(f"variant {dict(key)} {what}: device ms "
              + ", ".join(f"{t:.5f}" for t in ts))


def profile_launches(fn, reps: int) -> tuple:
    """(CUDA launches a call, device ms a call, {kernel name: [launches,
    device ms] a call}) of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names, us = collections.Counter(), collections.Counter()
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            names[name] += 1
            us[name] += e.device_time_total if hasattr(
                e, "device_time_total") else e.cuda_time_total
    return (sum(names.values()) / reps, sum(us.values()) / reps / 1e3,
            {k: [v / reps, us[k] / reps / 1e3]
             for k, v in names.most_common(8)})


def ntt_plain(ntt, gl, x, rate_bits, shift, inverse):
    """The plain composition around `dit_plain`, as ops/ntt.py has had it
    in every form."""
    from plonky2_tpu_torch.field import reference as ref
    n = x.shape[-1]
    lg_n = n.bit_length() - 1
    if inverse:
        buf = ntt.dit_plain(x.index_select(-1, ntt._perm("rev", n, x.device)),
                            0).index_select(-1, ntt._perm("ifft", n,
                                                          x.device))
        out = gl.mul_const(buf, ref.inverse_2exp(lg_n))
        return out if shift is None else gl.mul(
            out, ntt._shift_powers(ref.inverse(shift), n, x.device))
    if shift is not None:
        x = gl.mul(x, ntt._shift_powers(shift, n, x.device))
    x = x.index_select(-1, ntt._perm("rev", n, x.device))
    if rate_bits:
        x = x.repeat_interleave(1 << rate_bits, dim=-1)
    return ntt.dit_plain(x, rate_bits)


def _g(e: int) -> int:
    """7^e mod p: the coset shifts of the prover (e = 1) and of the FRI
    fold layers (7^(2^k))."""
    return pow(7, e, (1 << 64) - (1 << 32) + 1)


# (label, function name, batch, lg_n, rate_bits, shift, inverse)
NTT_CASES = [
    ("coset_lde [135, 2^14] rate 3", "coset_lde", 135, 14, 3, 7, False),
    ("coset_lde [20, 2^14] rate 3", "coset_lde", 20, 14, 3, 7, False),
    ("coset_lde [16, 2^14] rate 3", "coset_lde", 16, 14, 3, 7, False),
    ("ifft [135, 2^14]", "ifft", 135, 14, 0, None, True),
    ("ifft [20, 2^14]", "ifft", 20, 14, 0, None, True),
    ("coset_ifft [2, 2^17]", "coset_ifft", 2, 17, 0, 7, True),
    ("coset_fft [1, 2^13]", "coset_fft", 1, 13, 0, _g(16), False),
    ("coset_fft [1, 2^9]", "coset_fft", 1, 9, 0, _g(256), False),
    ("coset_fft [1, 2^5]", "coset_fft", 1, 5, 0, _g(4096), False),
    ("coset_fft_ext 2^13", "coset_fft_ext", 2, 13, 0, _g(16), False),
    ("coset LDE ext 2^14 rate 3", "coset_lde_ext", 2, 14, 3, 7, False),
]


def ntt_call(ntt, name, x, rate_bits, shift):
    """The prover's call of `name` on x ([2, n] for the extension forms,
    given as c0 and c1); earlier forms of ops/ntt.py have no
    coset_lde_ext and transform c0 and c1 apart."""
    from plonky2_tpu_torch.field.extension import GF2
    if name == "coset_fft_ext":
        g = ntt.coset_fft_ext(GF2(x[0], x[1]), shift)
        return [g.c0, g.c1]
    if name == "coset_lde_ext":
        if hasattr(ntt, "coset_lde_ext"):
            g = ntt.coset_lde_ext(GF2(x[0], x[1]), rate_bits)
            return [g.c0, g.c1]
        return [ntt.coset_lde(x[0], rate_bits), ntt.coset_lde(x[1], rate_bits)]
    if name == "coset_lde":
        return ntt.coset_lde(x, rate_bits)
    if name in ("ifft",):
        return ntt.ifft(x)
    return getattr(ntt, name)(x, shift)


def ntt_variants(variants, out_dir, device) -> None:
    """Build csrc/ntt.cu alone for each macro set and time its entries in
    turns, every output bit-checked against the plain composition."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.ops import ntt
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build_variants(variants, out_dir, "ntt.cu", "ntt")
    for lib in libs.values():
        lib.ntt_forward.argtypes = [p, p, ll, ll, i, i, p, p, p,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.ntt_inverse.argtypes = [p, p, ll, i, p, p, p,
                                    ctypes.POINTER(ctypes.c_int)]
    rng = np.random.default_rng(3)
    stream = lambda: torch.cuda.current_stream(device).cuda_stream
    cases = [("LDE [135, 2^14 -> 2^17]", 135, 14, 3, 7, False),
             ("iNTT [135, 2^14]", 135, 14, 0, None, True),
             ("LDE [20, 2^14 -> 2^17]", 20, 14, 3, 7, False),
             ("iNTT [20, 2^14]", 20, 14, 0, None, True),
             ("coset iNTT [2, 2^17]", 2, 17, 0, 7, True),
             ("LDE [2, 2^14 -> 2^17]", 2, 14, 3, 7, False),
             ("fold coset_fft [2, 2^13]", 2, 13, 0, _g(16), False),
             ("fold coset_fft [2, 2^9]", 2, 9, 0, _g(256), False)]
    inputs, wants = {}, {}
    for label, b, lg, r, shift, inv in cases:
        x = gl.from_u64(rng.integers(0, gl.ORDER, size=(b, 1 << lg),
                                     dtype=np.uint64), device)
        inputs[label] = x
        wants[label] = ntt_plain(ntt, gl, x, r, shift, inv)

    def call(lib, label, b, lg, r, shift, inv):
        x = inputs[label]
        out = torch.empty((b, 1 << (lg + r)), dtype=torch.int64,
                          device=device)
        n = ctypes.c_int(0)
        if inv:
            rc = lib.ntt_inverse(out.data_ptr(), x.data_ptr(), b, lg,
                                 ntt.inverse_scale(shift, 1 << lg,
                                                   device).data_ptr(),
                                 ntt.stage_twiddles(lg, True,
                                                    device).data_ptr(),
                                 stream(), ctypes.byref(n))
        else:
            rc = lib.ntt_forward(out.data_ptr(), x.data_ptr(), 1 << lg, b,
                                 lg, r, ntt._shift_powers(shift, 1 << lg,
                                                          device).data_ptr(),
                                 ntt.stage_twiddles(lg + r, False,
                                                    device).data_ptr(),
                                 stream(), ctypes.byref(n))
        assert rc == 0, rc
        return out, n.value

    for key, lib in libs.items():
        for case in cases:
            got, n = call(lib, *case)
            ok = torch.equal(got, wants[case[0]])
            print(f"variant {dict(key)} {case[0]}: {n} launches, "
                  f"{'bit-exact' if ok else 'DIFFERS'}")
            assert ok, (key, case[0])
    times = collections.defaultdict(list)
    for key in list(libs) + list(reversed(list(libs))):
        for case in cases:
            reps = 20 if case[1] * (1 << (case[2] + case[3])) >= 1 << 20 \
                else 200
            times[key, case[0]].append(device_ms_events(
                lambda: call(libs[key], *case), reps))
    for (key, what), ts in sorted(times.items()):
        print(f"variant {dict(key)} {what}: device ms "
              + ", ".join(f"{t:.5f}" for t in ts))


def ntt_main(args) -> int:
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.ops import ntt
    device = torch.device("cuda", 0)
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.variants:
        ntt_variants([tuple(tuple(d.split("=", 1)) for d in v.split(","))
                      for v in args.variants], args.out, device)
    print(f"build {backend.build():.3f} s", flush=True)
    for line in backend.PTXAS_REPORT.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    lib_path = max(glob.glob(os.path.join(backend.BUILD_DIR,
                                          "libplonky2_kernels-*.so")),
                   key=os.path.getmtime)
    for fn, hist in sass_histograms(lib_path, args.out, "ntt.cu").items():
        classes = collections.Counter()
        for op, n in hist.items():
            classes[opclass(op)] += n
        print(f"SASS {fn}: {sum(hist.values())} instructions; by class "
              + json.dumps(dict(classes.most_common())))
    rng = np.random.default_rng(11)
    rows, ok = [], True
    for label, name, b, lg, r, shift, inv in NTT_CASES:
        x = gl.from_u64(rng.integers(0, gl.ORDER, size=(b, 1 << lg),
                                     dtype=np.uint64), device)
        if b == 1:
            x = x[0]
        run = lambda: ntt_call(ntt, name, x, r, shift)
        got = run()
        same = torch.equal(torch.stack(got) if isinstance(got, list) else got,
                           ntt_plain(ntt, gl, x, r, shift, inv))
        ok &= same
        reps = 10 if b * (1 << (lg + r)) >= 1 << 20 else 100
        launches, prof_ms, names = profile_launches(run, reps)
        ev = device_ms_events(run, reps)
        wrap = wrapper_ms(run, reps)
        rows.append(dict(call=label, bit_exact=same, launches=launches,
                         profiler_ms=prof_ms, device_ms=ev, wrapper_ms=wrap,
                         kernels=names))
        print(f"{label}: {'bit-exact' if same else 'DIFFERS'}, "
              f"{launches:g} CUDA launches/call, profiler device "
              f"{prof_ms:.5f} ms, events device {ev:.5f} ms, wrapper "
              f"{wrap:.5f} ms; {names}", flush=True)
    print(json.dumps({"probe_ntt": rows}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=["hasher", "ntt"], default="hasher")
    ap.add_argument("--hasher", choices=sorted(HASHERS), default="poseidon")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "probe"))
    ap.add_argument("--variants", nargs="*", default=[],
                    metavar="MACRO=VALUE[,MACRO=VALUE...]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_poseidon_probe.py: no CUDA device", file=sys.stderr)
        return 1
    if args.kernel == "ntt":
        return ntt_main(args)
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl

    mod_name, source, prefix = HASHERS[args.hasher]
    mod = importlib.import_module(mod_name)
    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.variants:
        variants = [tuple(tuple(d.split("=", 1)) for d in v.split(","))
                    for v in args.variants]
        compare_variants(hasher_variants(variants, args.out, source, prefix),
                         device, mod, prefix)
    print(f"build {backend.build():.3f} s", flush=True)
    for line in backend.PTXAS_REPORT.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    lib_path = max(glob.glob(os.path.join(backend.BUILD_DIR,
                                          "libplonky2_kernels-*.so")),
                   key=os.path.getmtime)
    for fn, hist in sass_histograms(lib_path, args.out, source).items():
        classes = collections.Counter()
        for op, n in hist.items():
            classes[opclass(op)] += n
        print(f"SASS {fn}: {sum(hist.values())} instructions")
        print("  by class: " + json.dumps(dict(classes.most_common())))
        print("  by opcode: " + json.dumps(dict(hist.most_common(40))))

    rng = np.random.default_rng(11)
    rand = lambda *s: gl.from_u64(rng.integers(0, gl.ORDER, size=s,
                                               dtype=np.uint64), device)
    has_tree = hasattr(backend.lib(), f"{prefix}_merkle_tree")
    rows = []
    for b in (1 << 19, 1 << 15, 1 << 10, 256, 16):
        s = rand(b, 12)
        run = lambda: mod.permute(s)
        assert torch.equal(run(), mod.permute_plain(s)), b
        reps = 20 if b >= 1 << 15 else 200
        prof, per = device_ms_profiler(run, reps, "permute")
        rows.append((f"{prefix}_permute", [b], prof, per,
                     device_ms_events(run, reps), wrapper_ms(run, reps)))
    for L, n in ((135, 1 << 17), (84, 1 << 17), (20, 1 << 17),
                 (16, 1 << 17), (32, 1 << 13), (32, 1 << 9), (32, 1 << 5)):
        x = rand(L, n)
        run = lambda: mod.hash_leaves(x)
        assert torch.equal(run(), mod.hash_leaves_plain(x)), (L, n)
        reps = 10 if n >= 1 << 17 else 100
        prof, per = device_ms_profiler(run, reps, "leaves")
        rows.append((f"{prefix}_hash_leaves", [L, n], prof, per,
                     device_ms_events(run, reps), wrapper_ms(run, reps)))
    from plonky2_tpu_torch.hash import sponge
    plain_tree = lambda d, cap: sponge.merkle_layers_by_level(
        d, cap, lambda a, b: sponge.compress(a, b, mod.permute_plain))
    if has_tree:
        for lg_n, cap in ((20, 4), (17, 0), (11, 3), (10, 10), (8, 2), (1, 0)):
            d = rand(1 << lg_n, 4)
            got, want = mod.merkle_layers(d, cap), plain_tree(d, cap)
            assert len(got) == len(want) == lg_n - cap and all(
                torch.equal(a, b) for a, b in zip(got, want)), (lg_n, cap)
        print("merkle tree bit-exact at (20,4) (17,0) (11,3) (10,10) (8,2) "
              "(1,0)")
    for lg_n in (17, 13, 9, 5):
        d = rand(1 << lg_n, 4)
        got = torch.cat(mod.merkle_layers(d, 4))
        assert torch.equal(got, torch.cat(plain_tree(d, 4))), lg_n
        run = lambda: mod.merkle_layers(d, 4)
        # without the tree entry the levels are permutation launches
        prof, per = device_ms_profiler(run, 50, "merkle" if has_tree
                                       else "permute")
        rows.append((f"{prefix}_merkle_tree" if has_tree
                     else f"{prefix} merkle_layers", [1 << lg_n, 4], prof,
                     per, device_ms_events(run, 50), wrapper_ms(run, 50)))
    for name, shape, prof, per, ev, wrap in rows:
        print(f"{name} {shape}: profiler device {prof:.5f} ms "
              f"({per:g} launches/call), events device {ev:.5f} ms, "
              f"wrapper {wrap:.5f} ms")

    edge = np.array([0, 1, gl.ORDER - 1, 2**32 - 1, 2**32, gl.ORDER,
                     gl.ORDER + 1, 2**64 - 1], dtype=np.uint64)
    e = rng.integers(0, 2**64, size=(4096, 12), dtype=np.uint64)
    e[:2048] = edge[rng.integers(0, len(edge), size=(2048, 12))]
    e[0] = 2**64 - 1
    e = torch.from_numpy(e.view(np.int64)).to(device)
    got, want = mod.permute(e), mod.permute_plain(e)
    bad = (got != want).any(dim=1)
    edge_ok = not bool(bad.any())
    print(f"edge batch: {prefix}_permute " + (
        "bit-exact" if edge_ok else
        f"DIFFERS from its plain version in {int(bad.sum())} of 4096 states"
        f" (the all-(2^64 - 1) state {'differs' if bool(bad[0]) else 'agrees'})"
    ))
    print(json.dumps({"probe": [dict(name=n, shape=s, profiler_ms=p,
                                     launches_per_call=c, device_ms=e,
                                     wrapper_ms=w)
                                for n, s, p, c, e, w in rows]}))
    return 0 if edge_ok else 1


if __name__ == "__main__":
    sys.exit(main())
