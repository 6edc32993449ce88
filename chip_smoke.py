#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plonky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build the CUDA kernels from plonky2_tpu_torch/csrc (nvcc, sm_90a);
  2. fib100: build (seed 1234), prove and verify with the port, and match
     every field of tests/golden/fib100_transcript.json, proof bytes included;
  3. dummy-2^14: the base proof of the reference's bench_recursion
     (dummy_circuit(standard_recursion_config(), 14, 4), public input 0 = 42):
     build, prove cold and warm, verify, and reject a flipped public input;
     every kernel must have been launched by this phase;
  4. every kernel against its plain PyTorch version on the card, over full
     outputs, at every shape phase 3 launched it at (tolerance: bit-exact).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a GPU, and imports
nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None          # the port must not need JAX

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fib100_transcript.json")


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


@phase("fib100")
def fib100(device):
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.utils.serialization import serialize_proof_with_pis
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.get_challenges import get_challenges

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    proof = data.prove(pw)
    data.verify(proof)

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
    with open(GOLDEN) as f:
        want = json.load(f)
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        raise AssertionError(f"fib100 transcript fields diverged: {bad}")
    log(f"fib100: all {len(want)} golden transcript fields equal "
        f"(proof {len(got['proof_hex']) // 2} bytes)")


@phase("dummy-2^14")
def dummy_2_14(device):
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof

    backend.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    data, pis = dummy_circuit(CircuitConfig.standard_recursion_config(), 14,
                              4, device=device)
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
    shapes = {k.name: list(k.shapes) for k in backend.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated(device)

    tampered = copy.deepcopy(proof)
    tampered.public_inputs[0] = 43
    try:
        data.verify(tampered)
    except AssertionError as e:
        log(f"dummy-2^14: flipped public input rejected ({e})")
    else:
        raise AssertionError("a proof with a flipped public input verified")

    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the main path: "
                             f"{missing}")
    log(f"dummy-2^14: degree 2^{data.common.degree_bits}, FRI arities "
        f"{data.common.fri_params.reduction_arity_bits}, build "
        f"{t_build:.3f} s, prove cold {times[0]:.3f} s, warm {times[1]:.3f} "
        f"s, verify {t_verify:.3f} s, peak allocated "
        f"{peak / 2**20:.1f} MiB")
    log(f"dummy-2^14: launches {launches}")
    return launches, shapes


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


@phase("kernels vs plain")
def kernels_vs_plain(device, launches, shapes):
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash import poseidon as ps
    from plonky2_tpu_torch.ops import ntt

    rng = np.random.default_rng(7)

    def rand(*shape):
        return gl.from_u64(rng.integers(0, gl.ORDER, size=shape,
                                        dtype=np.uint64), device)

    def cases(name, shape):
        """(inputs, kernel call, plain call, elements) at one shape."""
        if name == "ntt_dit":
            batch, lg_n, start = shape
            x = rand(batch, 1 << lg_n)
            return (lambda: ntt.dit(x, start),
                    lambda: ntt.dit_plain(x, start), x.numel())
        if name == "poseidon_permute":
            s = rand(shape[0], ps.W)
            return (lambda: ps.permute(s), lambda: ps.permute_plain(s),
                    s.numel())
        x = rand(*shape)
        return (lambda: ps.hash_leaves(x), lambda: ps.hash_leaves_plain(x),
                x.numel())

    table = []
    for kern in backend.KERNELS.values():
        worst, largest = 0, None
        for shape in shapes[kern.name]:
            run, plain, size = cases(kern.name, shape)
            err = _max_abs_err(run(), plain())
            worst = max(worst, err)
            ms, plain_ms = _time_ms(run, 10), _time_ms(plain, 1)
            log(f"{kern.name} {shape}: max_abs_err {err}, kernel {ms:.4f} ms,"
                f" plain {plain_ms:.4f} ms")
            if largest is None or size > largest[0]:
                largest = (size, shape, ms, plain_ms)
        if worst:
            raise AssertionError(f"{kern.name} disagrees with its plain "
                                 f"version (max abs err {worst})")
        _, shape, ms, plain_ms = largest
        table.append({"name": kern.name, "route": "cuda",
                      "source": kern.source, "replaces": kern.replaces,
                      "launches": launches[kern.name], "max_abs_err": worst,
                      "shape": list(shape), "ms": ms, "plain_ms": plain_ms})
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
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(f"[build] kernels built/loaded in {backend.build():.3f} s")

    fib100(device)
    launches, shapes = dummy_2_14(device)
    table = kernels_vs_plain(device, launches, shapes)
    assert "jax" not in sys.modules or sys.modules["jax"] is None

    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
