"""starky_fib_r20 on the program: starky's FibonacciStark proved by the
port's `starky.prover.prove`, one proof a call, from a trace on the host.

Each request is a pair (x0, x1) drawn from the seed. Its trace, two uint64
columns of 2^degree_bits rows, is made here on the host, in numpy: row i
is (H(i), H(i + 1)) with H(j) = x0 F(j - 1) + x1 F(j) and F the Fibonacci
numbers mod p (F(-1) = 1, F(0) = 0), which set-up tabulates once.
"""

from __future__ import annotations

import numpy as np

from benchmark import plain

P = (1 << 64) - (1 << 32) + 1
EPS = np.uint64((1 << 32) - 1)
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


def draw(rng, cfg: dict) -> tuple[int, int]:
    x0, x1 = rng.integers(0, P, 2, dtype="uint64")
    return (int(x0), int(x1))


def _canonical(x: np.ndarray) -> np.ndarray:
    return np.where(x >= np.uint64(P), x - np.uint64(P), x)


def mul_scalar(x: np.ndarray, c: int) -> np.ndarray:
    """x * c mod p for canonical uint64 x and 0 <= c < p: the 128-bit
    product from 32-bit pieces, then 2^64 = 2^32 - 1 and 2^96 = -1."""
    xl, xh = x & M32, x >> S32
    cl, ch = np.uint64(c & 0xFFFFFFFF), np.uint64(c >> 32)
    t0, t1, t2, t3 = xl * cl, xl * ch, xh * cl, xh * ch
    u = (t1 & M32) + (t2 & M32)
    lo = t0 + ((u & M32) << S32)
    hi = (t1 >> S32) + (t2 >> S32) + t3 + (u >> S32) + (lo < t0)
    hh, hl = hi >> S32, hi & M32
    t = lo - hh
    t = np.where(lo < hh, t - EPS, t)
    m = hl * EPS
    s = t + m
    s = np.where(s < m, s + EPS, s)
    return _canonical(s)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    s = a + b
    return _canonical(np.where(s < a, s + EPS, s))


def fibonacci_table(n: int) -> np.ndarray:
    """F(-1), F(0), ..., F(n) mod p."""
    out = np.empty(n + 2, dtype=np.uint64)
    a, b = 1, 0
    for i in range(n + 2):
        out[i] = a
        a, b = b, (a + b) % P
    return out


class System:
    def __init__(self, cfg: dict, device, seed: int):
        from plonky2_tpu_torch.fri.config import (
            FriConfig, FriReductionStrategy,
        )
        from plonky2_tpu_torch.starky.config import StarkConfig
        from plonky2_tpu_torch.starky.fibonacci_stark import FibonacciStark
        fri = cfg["fri"]
        self.config = StarkConfig(
            security_bits=cfg["security_bits"],
            num_challenges=cfg["num_challenges"],
            fri_config=FriConfig(
                rate_bits=fri["rate_bits"], cap_height=fri["cap_height"],
                proof_of_work_bits=fri["proof_of_work_bits"],
                reduction_strategy=FriReductionStrategy(
                    kind="constant_arity", arity_bits=fri["arity_bits"],
                    final_poly_bits=fri["final_poly_bits"]),
                num_query_rounds=fri["num_query_rounds"]))
        self.n = 1 << cfg["degree_bits"]
        self.stark = FibonacciStark(self.n)
        self.device = device
        self.fib = fibonacci_table(self.n)

    def prepare(self, inputs: list) -> list:
        """(trace [2, n], public inputs) of each request."""
        out = []
        for x0, x1 in inputs:
            h = add(mul_scalar(self.fib[:self.n + 1], x0),
                    mul_scalar(self.fib[1:], x1))
            trace = np.stack([h[:-1], h[1:]])
            out.append((trace, [x0, x1, int(h[self.n])]))
        return out

    def prove(self, prepared: list, timing) -> list:
        from plonky2_tpu_torch.starky.prover import prove
        return [prove(self.stark, self.config, trace, pis, timing=timing,
                      device=self.device) for trace, pis in prepared]

    @staticmethod
    def plain(proof) -> dict:
        p = proof.proof
        o = p.openings
        caps = [p.trace_cap]
        if p.auxiliary_polys_cap is not None:
            caps.append(p.auxiliary_polys_cap)
        caps.append(p.quotient_polys_cap)
        return {
            "public_inputs": plain.ints(proof.public_inputs),
            "caps": [plain.digests(c) for c in caps],
            "openings": {name: plain.ext(getattr(o, name)) for name in (
                "local_values", "next_values", "quotient_polys")},
            "fri": plain.fri_proof(p.opening_proof),
        }

    def close(self) -> None:
        self.stark = None
