#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plonky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build the CUDA kernels from plonky2_tpu_torch/csrc (one nvcc per
     source, in parallel, sm_90a);
  2. fib100: build (seed 1234), prove and verify with the port under
     PoseidonGoldilocksConfig, and match every field of
     tests/golden/fib100_transcript.json, proof bytes included;
  3. fib21-poseidon2: the same for fib(21) under Poseidon2GoldilocksConfig
     against tests/golden/fib21_Poseidon2GoldilocksConfig_transcript.json;
  4. dummy-2^14: the base proof of the reference's bench_recursion
     (dummy_circuit(standard_recursion_config(), 14, 4), public input
     0 = 42) under Poseidon: build, prove cold and warm, verify, and reject
     a flipped public input; K1, K2 and K3 must have been launched;
  5. dummy-2^14-poseidon2: the same circuit under Poseidon2; K1, K6 and K7
     must have been launched;
  6. every kernel against its plain PyTorch version on the card, over full
     outputs, at every shape phases 4 and 5 launched it at (tolerance:
     bit-exact), with its time, the plain version's time and its bound.
The kernel counts are set to 0 just before phases 4 and 5 and read just
after each. The line before the last is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a GPU, and
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

sys.modules["jax"] = None          # the port must not need JAX
sys.modules["plonky2_tpu"] = None  # nor the JAX package

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
P2 = "Poseidon2GoldilocksConfig"

# H100 SXM: HBM bytes/s (NVIDIA data sheet) and the 32-bit integer
# multiply-add rate of one SM per clock (64 INT32 lanes)
HBM_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_PER_SM_CLK = 64
# general (full 64-bit) field multiplies per permutation, from the
# algorithm. Poseidon: the x^7 S-boxes, 4 multiplies each, of 8 full rounds
# x 12 and 22 partial rounds x 1; its MDS constants are below 2^6 (shifts
# and adds), so it has no other. Poseidon2: the same S-boxes in 8 full
# rounds x 12 and 22 internal rounds x 1, plus the 22 x 12 products by the
# full 64-bit internal diagonal
FIELD_MULS = {"poseidon_permute": (8 * 12 + 22) * 4,
              "poseidon2_permute": (8 * 12 + 22) * 4 + 22 * 12}
# a 64 x 64 -> 128-bit product takes at least four 32-bit partial products;
# the Goldilocks reduction takes shifts and adds only
MIN_IMAD_PER_FIELD_MUL = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Decorator: run, time and report one phase."""
    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            log(f"[{name}] ok in {time.perf_counter() - t0:.3f} s")
            return out
        return run
    return wrap


def _fib(steps: int, gc, device):
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(steps):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    data = builder.build(device=device, gc=gc)
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    proof = data.prove(pw)
    data.verify(proof)
    return data, proof


def _golden(name: str, data, proof, path: str) -> None:
    from plonky2_tpu_torch.plonk.get_challenges import get_challenges
    from plonky2_tpu_torch.utils.serialization import (
        serialize_proof_with_pis,
    )

    common = data.common
    pi_hash = common.gc.hash_public_inputs(proof.public_inputs)
    ch = get_challenges(proof, pi_hash, data.verifier_only.circuit_digest,
                        common)
    fc = ch.fri_challenges
    got = {
        "circuit_digest": list(data.verifier_only.circuit_digest),
        "public_inputs": list(proof.public_inputs),
        "pi_hash": list(pi_hash),
        "betas": list(ch.plonk_betas), "gammas": list(ch.plonk_gammas),
        "alphas": list(ch.plonk_alphas), "zeta": list(ch.plonk_zeta),
        "fri_alpha": list(fc.fri_alpha),
        "fri_betas": [list(x) for x in fc.fri_betas],
        "fri_pow_response": fc.fri_pow_response,
        "fri_query_indices": list(fc.fri_query_indices),
        "pow_witness": proof.proof.opening_proof.pow_witness,
        "proof_hex": serialize_proof_with_pis(proof, common).hex(),
    }
    with open(path) as f:
        want = json.load(f)
    bad = [k for k in want if got[k] != want[k]]
    if bad or len(want) != 13:
        raise AssertionError(f"{name} transcript fields diverged: {bad}")
    log(f"{name}: all {len(want)} golden transcript fields equal "
        f"(proof {len(got['proof_hex']) // 2} bytes)")


@phase("fib100")
def fib100(device):
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    data, proof = _fib(99, PoseidonGoldilocksConfig, device)
    _golden("fib100", data, proof,
            os.path.join(GOLDEN_DIR, "fib100_transcript.json"))


@phase("fib21-poseidon2")
def fib21_poseidon2(device):
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    data, proof = _fib(20, CONFIGS[P2], device)
    _golden("fib21-poseidon2", data, proof,
            os.path.join(GOLDEN_DIR, f"fib21_{P2}_transcript.json"))


def _dummy(name: str, gc, device, kernels: tuple):
    """Build, prove cold and warm, verify and tamper-check the 2^14 dummy
    circuit under `gc`; the counts are set to 0 just before and read just
    after. Returns {kernel: launches} and {kernel: {shape: launches}}."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    backend.reset_counts()
    t0 = time.perf_counter()
    data, pis = dummy_circuit(CircuitConfig.standard_recursion_config(), 14,
                              4, device=device, gc=gc)
    t_build = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        proof = dummy_proof(data, pis, {0: 42})
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    data.verify(proof)
    t_verify = time.perf_counter() - t0
    launches = {k.name: k.launches for k in backend.KERNELS.values()}
    shapes = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated(device)

    tampered = copy.deepcopy(proof)
    tampered.public_inputs[0] = 43
    try:
        data.verify(tampered)
    except AssertionError as e:
        log(f"{name}: flipped public input rejected ({e})")
    else:
        raise AssertionError("a proof with a flipped public input verified")

    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched by the main "
                             f"path: {missing}")
    log(f"{name}: {data.common.gc.name}, degree 2^{data.common.degree_bits},"
        f" FRI arities {data.common.fri_params.reduction_arity_bits}, build "
        f"{t_build:.3f} s, prove cold {times[0]:.3f} s, warm {times[1]:.3f} "
        f"s, verify {t_verify:.3f} s, peak allocated "
        f"{peak / 2**20:.1f} MiB")
    log(f"{name}: launches {launches}")
    return launches, shapes


@phase("dummy-2^14")
def dummy_2_14(device):
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    return _dummy("dummy-2^14", PoseidonGoldilocksConfig, device,
                  ("ntt_dit", "poseidon_permute", "poseidon_hash_leaves"))


@phase("dummy-2^14-poseidon2")
def dummy_2_14_poseidon2(device):
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    return _dummy("dummy-2^14-poseidon2", CONFIGS[P2], device,
                  ("ntt_dit", "poseidon2_permute", "poseidon2_hash_leaves"))


def _time_ms(fn, reps: int) -> float:
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


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if torch.equal(a, b):
        return 0
    ua = a.cpu().numpy().view(np.uint64).reshape(-1)
    ub = b.cpu().numpy().view(np.uint64).reshape(-1)
    diff = np.nonzero(ua != ub)[0]
    return max(abs(int(ua[i]) - int(ub[i])) for i in diff)


def _bound(name: str, shape, clock_mhz: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the function moves over
    HBM bandwidth and the 32-bit multiply-adds its field multiplies need
    (MIN_IMAD_PER_FIELD_MUL each) over the card's IMAD rate at `clock_mhz`.
    Adds, reductions and small-constant products are not counted: a
    floor."""
    if name == "ntt_dit":
        batch, lg_n, start = shape
        n = 1 << lg_n
        nbytes = 8 * (2 * batch * n + n // 2)
        imads = MIN_IMAD_PER_FIELD_MUL * batch * (lg_n - start) * (n // 2)
    elif name.endswith("_permute"):
        nbytes = 2 * 8 * 12 * shape[0]
        imads = FIELD_MULS[name] * MIN_IMAD_PER_FIELD_MUL * shape[0]
    else:
        L, n = shape
        perm = name.replace("hash_leaves", "permute")
        nbytes = 8 * (L * n + 4 * n)
        imads = (FIELD_MULS[perm] * MIN_IMAD_PER_FIELD_MUL * n
                 * math.ceil(L / 8))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / (SMS * IMAD_PER_SM_CLK * clock_mhz * 1e6) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


@phase("kernels vs plain")
def kernels_vs_plain(device, launches, shapes, clock_mhz):
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash import poseidon as ps
    from plonky2_tpu_torch.hash import poseidon2 as ps2
    from plonky2_tpu_torch.ops import ntt

    rng = np.random.default_rng(7)
    mods = {"poseidon": ps, "poseidon2": ps2}

    def rand(*shape):
        return gl.from_u64(rng.integers(0, gl.ORDER, size=shape,
                                        dtype=np.uint64), device)

    def cases(name, shape):
        """(kernel call, plain call, elements) at one shape."""
        if name == "ntt_dit":
            batch, lg_n, start = shape
            x = rand(batch, 1 << lg_n)
            return (lambda: ntt.dit(x, start),
                    lambda: ntt.dit_plain(x, start), x.numel())
        mod = mods[name.rsplit("_", 2)[0]]
        if name.endswith("_permute"):
            s = rand(shape[0], 12)
            return (lambda: mod.permute(s), lambda: mod.permute_plain(s),
                    s.numel())
        x = rand(*shape)
        return (lambda: mod.hash_leaves(x), lambda: mod.hash_leaves_plain(x),
                x.numel())

    table = []
    for kern in backend.KERNELS.values():
        worst, largest = 0, None
        for shape in shapes[kern.name]:
            run, plain, size = cases(kern.name, shape)
            err = _max_abs_err(run(), plain())
            worst = max(worst, err)
            ms, plain_ms = _time_ms(run, 10), _time_ms(plain, 1)
            bound_ms, bound_by = _bound(kern.name, shape, clock_mhz)
            log(f"{kern.name} {shape}: max_abs_err {err}, kernel {ms:.4f} ms,"
                f" plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            if largest is None or size > largest[0]:
                largest = (size, shape, ms, plain_ms, bound_ms, bound_by)
        if worst:
            raise AssertionError(f"{kern.name} disagrees with its plain "
                                 f"version (max abs err {worst})")
        _, shape, ms, plain_ms, bound_ms, bound_by = largest
        entry = {"name": kern.name, "route": "cuda", "source": kern.source,
                 "replaces": kern.replaces,
                 "launches": launches[kern.name], "max_abs_err": worst,
                 "shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 # no single PyTorch call computes a Goldilocks NTT or a
                 # Poseidon/Poseidon2 permutation or sponge
                 "library_ms": None}
        if kern.name == "poseidon_permute":
            # K4 (v1) and K5 (v2) are tilings of K2's permutation on the
            # TPU; this kernel takes any batch and serves all three
            entry["replaces"] = ("plonky2_tpu/ops/pallas_poseidon.py:335 "
                                 "(K2), :77 (K4), :372 (K5)")
            small = [s for s in shapes[kern.name] if s[0] < 512]
            entry["held_below_512"] = [list(s) for s in small]
            entry["launches_below_512"] = sum(shapes[kern.name][s]
                                              for s in small)
        table.append(entry)
    return table


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plonky2_tpu_torch import backend

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, max SM clock {clock:.0f} MHz")
    log(f"[build] kernels built/loaded in {backend.build():.3f} s")
    for line in backend.PTXAS_REPORT.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(line.strip())

    fib100(device)
    fib21_poseidon2(device)
    launches, shapes = dummy_2_14(device)
    launches2, shapes2 = dummy_2_14_poseidon2(device)
    for k in launches:
        launches[k] += launches2[k]
        for s, n in shapes2[k].items():
            shapes[k][s] = shapes[k].get(s, 0) + n
    table = kernels_vs_plain(device, launches, shapes, clock)
    assert sys.modules["jax"] is None and sys.modules["plonky2_tpu"] is None

    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
