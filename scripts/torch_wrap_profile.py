#!/usr/bin/env python3
"""Profile a warm prove of the port's recursive wraps on one NVIDIA GPU:

    python3 scripts/torch_wrap_profile.py [--out DIR]

Builds fib(100) and its wrap (tests/golden_common.py's build_fib100_wrap:
seed 1234, standard_recursion_config()), and the dummy-2^14 proof and its
wrap (wrap-1 of the reference's bench_recursion), all with the port on the
card. For each wrap it prints:
  - a warm prove's host seconds (ends in a synchronize);
  - under torch.profiler, that prove's CUDA launches and the device time
    of its kernels, and their sum over the profiled prove's host time
    (the device's busy share: the kernels run on one stream);
  - the same for round 3 alone ("compute quotient polys"), profiled inside
    another prove through the TimingTree the prover scopes its phases with
    (`plonk/prover.py`);
  - for each gate type of the circuit, `eval_unfiltered_rows` on random
    rows of the round-3 grid's width: CUDA launches, device ms and host ms
    (CUDA events around back-to-back calls).
The numbers also go to DIR/wrap_profile.json (default chiprun_out).
Imports nothing of JAX or of the JAX package; exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def profiled(out: dict):
    """Into `out`: the CUDA launches of the block under torch.profiler,
    their device ms, the block's host ms, and the kernels' share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    launches, device_us = 0, 0.0
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            device_us += getattr(e, "device_time_total", None) or \
                e.cuda_time_total
    out.update(launches=launches, device_ms=device_us / 1e3,
               host_ms=host_ms, busy=device_us / 1e3 / host_ms)


def events_ms(fn, reps: int = 3) -> float:
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


def wrap(inner, proof, device):
    """(wrap data, its witness) of `proof`."""
    from plonky2_tpu_torch.recursion.verifier import wrap_circuit
    builder, witness = wrap_circuit(inner)
    return builder.build(device=device), witness(proof)


def profile_wrap(name, data, pw, device) -> dict:
    from plonky2_tpu_torch.field import goldilocks as gl

    data.prove(pw)                                  # cold
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = data.prove(pw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    data.verify(proof)
    common = data.common
    out = {"degree_bits": common.degree_bits, "warm_prove_s": warm_s,
           "prove": {}, "round_3": {}, "gates": {}}
    with profiled(out["prove"]):
        data.prove(pw)

    from plonky2_tpu_torch.utils.timing import TimingTree

    class Round3(TimingTree):
        """Profiles the prover's round-3 scope and times nothing else."""

        def scope(self, label, device=None):
            return (profiled(out["round_3"])
                    if label == "compute quotient polys"
                    else contextlib.nullcontext())
    data.prove(pw, Round3())
    # the grid of round 3: degree x 2^ceil(lg qdf) points
    N = common.degree << (common.quotient_degree_factor - 1).bit_length()
    rng = np.random.default_rng(5)

    def rand(*shape):
        return gl.from_u64(rng.integers(0, gl.ORDER, size=shape,
                                        dtype=np.uint64), device)
    wires, consts, pi = (rand(common.config.num_wires, N),
                         rand(common.config.num_constants, N), rand(4, N))
    for gate in common.gates:
        if gate.num_constraints() == 0:
            continue
        run = lambda: gate.eval_unfiltered_rows(consts, wires, pi)
        stats = {}
        with profiled(stats):
            run()
        stats["events_ms"] = events_ms(run)
        stats["constraints"] = gate.num_constraints()
        out["gates"][gate.id()] = stats
    print(f"{name}: degree 2^{common.degree_bits}, warm prove {warm_s:.3f} "
          f"s; profiled prove {out['prove']}; round 3 {out['round_3']}",
          flush=True)
    for gid, st in sorted(out["gates"].items(),
                          key=lambda kv: -kv[1]["events_ms"]):
        print(f"{name}: {gid[:60]}: {st['constraints']} constraints, "
              f"{st['launches']} launches, device {st['device_ms']:.3f} ms, "
              f"host {st['events_ms']:.3f} ms", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wrap_profile.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_proof

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    backend.build()

    config = CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config, seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    fib = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    result = {"fib100-wrap": profile_wrap(
        "fib100-wrap", *wrap(fib, fib.prove(pw), device), device)}
    dummy, pis = dummy_circuit(config, 14, 4, device=device)
    result["wrap-1"] = profile_wrap(
        "wrap-1", *wrap(dummy, dummy_proof(dummy, pis, {0: 42}), device),
        device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "wrap_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
