"""What the examples share: their command line, the card's clock and the
fib(100) circuit of `fibonacci`, `fibonacci_serialization` and
`batch_prove`."""

from __future__ import annotations

import argparse
import time

import torch

from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..utils.timing import stop_profiler


def parse(description: str, argv, *arguments) -> argparse.Namespace:
    """The example's arguments: each of `arguments` is (args, kwargs) of
    `add_argument`; every example also takes --device and --seed."""
    ap = argparse.ArgumentParser(description=description)
    for args, kwargs in arguments:
        ap.add_argument(*args, **kwargs)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the builder's random stream (the unused "
                         "wires of a prove); unseeded by default")
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to prove on "
                           "the CPU")
    return args


def builder(seed: int | None) -> CircuitBuilder:
    return CircuitBuilder(CircuitConfig.standard_recursion_config(),
                          seed=seed)


def clock(device) -> float:
    """The host clock once the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def fib_circuit(seed: int | None):
    """fib(100) from public initial values (reference: fibonacci.rs): the
    unbuilt builder, its two initial targets and the 100th term's, all
    three public inputs."""
    b = builder(seed)
    initial_a = b.add_virtual_target()
    initial_b = b.add_virtual_target()
    prev, cur = initial_a, initial_b
    for _ in range(99):
        prev, cur = cur, b.add(prev, cur)
    for t in (initial_a, initial_b, cur):
        b.register_public_input(t)
    return b, initial_a, initial_b, cur


def run(main) -> None:
    """Run an example's main as a program; under PLONKY2_TPU_PROFILE, write
    the profiler's trace at its end."""
    try:
        main()
    finally:
        path = stop_profiler()
        if path is not None:
            print(f"profiler trace: {path}")
